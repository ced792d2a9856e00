#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: build the kernels, hold each
against its plain PyTorch version, run the GraphSession end to end on
both layouts — in memory, sharded over a mesh, durable and indexed,
reopened and crashed, replicated — run the paper's serving driver,
serve five decoder LMs (prefill + greedy decode) at their published
width and depth, an encoder-decoder (whisper-small) and a VLM
(internvl2-1b) at theirs, two mixture-of-experts LMs (mixtral-8x7b,
kimi-k2) at their published width, as deep as the card holds, and a
hybrid LM (jamba-1.5-large) at its published width over one period, and
train the two decoder LMs, with delta checkpoints and a recovery, the
encoder-decoder, VLM and MoE LMs, and the dense, MoE, SSM,
encoder-decoder and VLM LMs on a ``DeviceMesh``, and serve all six
families on it.

    python3 chip_smoke.py                 # full size, one card
    python3 chip_smoke.py --dense-nodes 1024 --edge-nodes 4096 \
        --lm-layers 4                     # quick
    python3 chip_smoke.py --first-call    # a new kernel's first call:
        # build with ptxas's registers / shared memory / spills per
        # kernel instance, every graph-kernel case at a small size and
        # small LM-kernel cases against their plain versions, stop

Phases, in order (any failure exits non-zero):

1. build — compile the six kernels (``repro_torch.kernels.build``) and
   print the card's name and power limit as nvidia-smi reports them;
2. kernels — call each kernel's wrapper at the shapes the main path
   launches it with and compare with the plain version: the four graph
   kernels on the sessions' own data, bit for bit, and, untimed, the
   other paths of dense LWW reconstruction (per-query anchors and
   windows both ways, a ``row_mask``, N = 1000 and 1008), of edge-slot
   LWW reconstruction (per-query anchors and windows both ways, the
   dense session's slot layout, a ragged E), the block forms a sharded
   group runs — dense LWW on four row blocks of N/4 rows (timed) and on
   the 125-row blocks of N = 1000 over 8 shards, edge-slot LWW on four
   slot blocks of E/4 (timed) and on a ragged split — each also equal
   to its block of the whole-graph kernel's output, of the hybrid degree
   series (B = 512 with the nets in global memory, a ragged N, four node
   blocks of N/4 each equal to its rows of the whole kernel's) and of
   the degree sweep (four windows, the dense session's N, B = 512), the
   kernel lines carrying the counts the designs turn on; flash
   attention (at the smollm-360m prefill shape, at the mixtral-8x7b
   prefill shape — B 8, S 2048, Hq 32, Hkv 8, D 128, bf16, window
   4096, which covers every key, so the library runs causal — at
   phase 14's four: whisper-small's encoder (B 8, H 12, S 1500, D 64,
   full), its cross-attention (Sq 416 against Skv 1500, full) and its
   decoder's self-attention (S 416, causal), internvl2-1b's prefill (B
   8, Hq 14, Hkv 2, S 2304, D 64, causal), kimi-k2's prefill (B 8, Hq
   64, Hkv 8, S 2048, D 112, causal: run padded to D 128) and phase 16's
   jamba-1.5-large prefill (the same with D 128), and phase 18's three:
   gemma-2b (B 8, Hq 8, Hkv 1, S 2048, D 256), olmo-1b (Hq 16, Hkv 16,
   D 128) and glm4-9b (Hq 32, Hkv 2, D 128), causal, all bf16 — plus
   head dims 128 / 256, and a sliding window and a kv_len-padded non-causal
   case with ragged Sq, each in float32 and bf16) and the
   SSD scan (at the mamba2-130m prefill shape, output and final state,
   from a zero state and continuing a cache, and at jamba-1.5-large's,
   H 256) on seeded random inputs,
   within the tolerance printed.  Each main case is timed (CUDA
   events, behind a device sleep that covers the host's launches; the
   host's own time per call beside it) beside its bound, the plain
   version and, for attention, PyTorch's
   ``scaled_dot_product_attention`` as the library yardstick;
   edge-slot LWW is timed at one query too; the series' work list,
   which their blocks derive on the card, is held against its plain
   version; dense and edge-slot LWW are also timed at
   crash recovery's shapes (one query over the whole log, (0, t_cur],
   from the empty graph);
3. dense session — ``GraphSession(n_cap=8192, layout="dense")`` ingests
   the paper's Table 3 evolution parameters in several flushed batches,
   then a mixed ``query_many`` (point / diff / agg, node and global,
   degree_distribution and triangles), sweeps and a snapshot;
4. edge session — the same at ``n_cap=131072``, ``layout="edge"``;
5. smollm-360m and 6. mamba2-130m — bf16 weights from a seeded
   ``torch.Generator``, prefill of 8 prompts of 2048 seeded tokens
   (``cache_cap`` 2080), 32 greedy decode steps, and the float32
   card-vs-CPU check at 6 layers (``F32_CHECK_LAYERS``, the cut
   printed) (``phase_lm``, verdict ``family_failures``);
7. durable indexed sessions — the sessions of phases 3 and 4 again with
   ``path=`` (a temporary root) and ``indexed=True``: the same ops in
   the same flushed batches and the same mix, then ``close`` and
   ``GraphSession.open(path)``, which recovers on the card, and the mix
   again; both sets of answers, the snapshot and ``current`` must equal
   the in-memory session's bit for bit, the reopen must launch dense
   (dense) or edge-slot (edge) LWW, and queries must run through the
   node-centric index.  The host time of every step is printed, the
   reopen split into load, host rebuild, card rebuild, replay, serving
   state and the first ``query_many`` (read from ``open_store``'s
   trace spans), and the root's bytes.  On the reopened engine, a group
   of 512 node queries of each measure-only plan (hybrid points,
   delta-only diffs) runs forced indexed and forced unindexed in turn:
   both times are printed, and the answers must be equal bit for bit;
8. one crash — a child process (``--crash-child``) runs the dense
   configuration durably on the card and SIGKILLs itself right after
   the drain record of its second swap; reopened on the card, the store
   must hold every acknowledged batch, and every query of the mix at
   t ≤ the recovered watermark, ``current`` and a snapshot must
   bit-match a from-scratch card session over the same ops, before and
   after a ``flush``;
9. replication — on both layouts, at the configurations of phases 3 and
   4: a durable writer publishes every swap (``publish_to``) into a
   publish root; replica A (``GraphSession.open_replica``) syncs after
   each flush and must catch up by diff (``rotate`` / ``incremental``,
   no full rebuild); replica B opens after the last flush — readonly
   recovery on the card, which must launch dense (dense) or edge-slot
   (edge) LWW — on dense with an anchor budget, whose
   ``refresh_anchors`` after the routed mix must launch dense LWW; a
   router (``open_router``) over both serves the mix twice (A, then B),
   A is stopped and the mix routed again (failover to B), and a batch
   past every watermark must raise ``WatermarkError``: every answer and
   each replica's ``current`` must equal the in-memory session's bit for
   bit.  On dense also replica T, synced by its own poll thread
   (``start``, after each of A's syncs) while the main thread serves
   the covered queries of the mix from it, again and again, until it
   reaches the new watermark (engines built on the card while older
   ones answer; the thread is stopped then, before any launch count is
   read), a replica whose transport
   flips a bit of the first segment fetch (one payload quarantined,
   answers exact), and a kill -9: a child (``--replica-child``) reopens a copy of A's mirror
   from an earlier swap, syncs and SIGKILLs itself after the new segment
   files reach the mirror and before its manifest rename; the mirror,
   reopened on the card, must serve its old watermark before any fetch
   and rejoin by diff.  Printed: publish seconds and bytes a swap, sync
   seconds by mode, bytes fetched, B's open split (``recovery.*``
   spans), routed and failover seconds, peak device memory.

10. sharded — on a mesh of four shards over the visible cards in turn:
   ``graph_mesh(["cuda:0"] * 4)`` on one card (the card named four
   times, each shard a tensor of its own), cuda:0..3 on four: a dense
   ``GraphSession(n_cap=8192, mesh=)`` ingests phase 3's ops in the
   same four flushed batches and serves the mix, the sweeps and a
   snapshot; phase 4's store is placed on the mesh (``place_on_mesh``).
   On both the mix runs again with ``shard="force"`` (dense: also with
   every layout pinned dense) and with ``shard="never"``; every answer (dense: the sweeps, forced too, and
   the snapshot) must equal the in-memory session's bit for bit.  No
   group of the ``"auto"`` mix may shard; the forced groups must all
   shard, in ``rows`` and ``batch`` modes (dense)
   or ``slots`` and ``batch`` with an ``evolve`` group through
   ``evolve_slots`` (edge); dense LWW must launch on row blocks (dense),
   edge-slot LWW on slot blocks and dense LWW never (edge).  On dense,
   ``dist_reconstruct``, ``dist_triangles`` and
   ``dist_batch_point_degree`` must equal their single-device values.
   Printed: each step's host seconds (card synchronized), the modes,
   launches (on blocks apart) and peak device memory.

11. training — through ``repro_torch.launch.train.train`` on the card:
   (a) smollm-360m (bf16 params) and (b) mamba2-130m (float32) at
   published width and depth, ``TrainConfig`` defaults (AdamW in
   float32, ``remat="block"``), 8 × 2048 tokens, 6 steps, warmup 1:
   every parameter's first-step gradient finite and nonzero, loss and
   grad norm finite at every step, the model's kernel launched twice a
   layer a step (forward, and the remat recompute; its backward is the
   plain version), no other kernel; printed: step seconds, one step's
   device time split into forward / backward / optimizer
   (``torch.profiler``), peak memory and the plain backward's share of
   a step.  (c) mamba2-130m under deterministic algorithms: an
   uninterrupted run, then the same run checkpointing every 2nd step
   into a delta store (a temporary root) with one injected failure at
   step 3: the state restored at the failure must equal the state saved
   there, and the final state the uninterrupted run's, bit for bit;
   printed: storage bytes, save and restore seconds; 2 of mamba2's 24
   layers (``RECOVERY_LAYERS``, the cut printed).  (d) both models, 2
   layers at full width, float32, 2 × 256 tokens, 3 steps on the card
   and on the CPU from the same initial state: per-step loss and grad norm within the
   tolerance printed.

12. serving driver — ``repro_torch.launch.serve.main`` (the paper's
   workload driver, ``--nodes 8192 --queries 1024 --seed 7``: the
   dense size of phase 3) on every visible card and on ``cuda:0``
   named four times, so that ``dist_batch_point_degree``'s psum runs:
   ``build_store``, ``shard_graph`` of the current snapshot, 1,024
   point-degree queries on the mesh, the five mixed plan-matrix
   queries through ``store.query``.  The point degrees must be equal
   bit for bit across the meshes and to a host numpy oracle over the
   generator's op list; the mixed answers across the meshes and to the
   same queries through ``evaluate_many``; each run must launch a
   kernel (the global queries' two-phase plan runs dense LWW).
   Printed: build, batch and mixed seconds and the launches of each
   run, beside the card's name and power limit.

13. mixtral-8x7b — the MoE family (``models/moe.py``) at published
   width (d 4096, 32 / 8 heads of 128, 8 experts top-2 of d_ff 14336,
   swiglu, vocab 32000, window 4096, capacity_factor 1.25), 24 of its
   32 layers (70.2 GB of bf16; a step of 4 down while the weights and
   8 GiB of activations exceed the free memory, ``--lm-layers``
   overrides), random bf16 weights from a seeded generator.  First
   everything earlier phases hold is freed, and more than 2 GiB still
   allocated fails the phase.  (a) prefill 8 × 2048 and 32 greedy
   decode steps, counters zeroed around each: one flash-attention
   launch per layer per prefill, no other kernel, none in decode; (b)
   one prefill's routing read through forward hooks on the MoE modules:
   the share of (token, choice) pairs dropped and the fullest expert
   against the capacity (5120), and some pair must drop; (c) decode
   against a fresh forward over sequence 0 at the check-only
   capacity_factor E / k = 4 (capacity = T, so neither path can drop:
   at 1.25 a decode step of 8 tokens never drops and a 2080-token
   forward does, two different functions in the reference itself).
   The rules: in bf16 a step at which no layer routes sequence 0's
   token differently from the forward is held to 2^-4 (the first) or
   2^-2.  A step with such a route flip is re-run from the same cache
   and its flips judged one at a time in layer order: each must be a
   near-tie — the forward's gap between its k-th and (k+1)-th router
   logits at most the largest |Δ router logit| between decode and
   forward for that token and layer — and is then pinned to the
   forward's experts for the next re-run, so that every flip is judged
   on inputs that differ from the forward's by rounding alone (a flip
   that is gone once the earlier ones are pinned follows from them).
   The re-run with every judged flip pinned is held to the step's
   tolerance, and an unpinned re-run must give the step's logits bit
   for bit.  In float32 (1 layer at full width) no flip at all and
   every step within ``F32_CARD_CPU_RTOL``.  (d) that float32 layer on
   the card and on the CPU at the published capacity, one prompt of 256
   tokens and 8 steps (DENSE_CHECK_DECODE, the cut printed): logits
   within ``F32_CARD_CPU_RTOL``, the same
   greedy tokens, and every MoE call's top-k, keep mask and slots equal.
   Printed: parameters, the cut, peak memory, prefill seconds and
   tokens/s (warm and cold), decode ms/step, the device profile of one
   prefill and of 8 decode steps, each route flip's gap and Δ and how
   its step was judged, beside
   the card's name and power limit; the verdict is ``moe_failures``,
   read after phase 11 (a failed check then exits 1, phase 11 run).

14. whisper-small and internvl2-1b — the encoder-decoder
   (``models/encdec.py``: 12 encoder and 12 decoder layers, d 768, 12
   heads of 64, d_ff 3072, gelu, LayerNorm, learned positions, vocab
   51865, 1500 encoder frames) and the VLM (``models/lm.py``'s vlm
   branches: 24 layers, d 896, 14 / 2 heads of 64, d_ff 4864, swiglu,
   rope, vocab 151655, 256 patch embeddings) at published width and
   depth, random bf16 weights from a seeded generator, seeded bf16
   frames / patches (the frontends are stubs), batch 8: whisper a
   decoder prompt of 416 tokens (``cache_cap`` 448, Whisper's text
   context), internvl2 256 patches + 2048 tokens (``cache_cap`` 2336,
   decode positions after the patches); 32 greedy steps each, through
   ``phase_lm`` as phases 5 and 6.  (a) counters zeroed around the
   prefill and the decode: flash attention 36 times a whisper prefill
   (12 encoder + 12 decoder self + 12 cross), 24 an internvl2 one, no
   other kernel, none in decode; (b) bf16 decode against a fresh
   forward over sequence 0 (its frames / patches included) within
   BF16_FIRST_STEP_RTOL / BF16_DECODE_RTOL; (c) float32 on the card
   against the CPU at 6 layers (whisper 6 + 6; ``F32_CHECK_LAYERS``,
   as (d); the cut printed; whisper all 1500 frames, internvl2
   256 patches, + 256 tokens + 32 steps) within F32_CARD_CPU_RTOL, the
   same greedy tokens; (d) whisper with float32 frames under bf16
   weights (JAX's promotion): B5 in float32 for the encoder and the
   cross-attention, in bf16 for the decoder's self-attention, counted
   by dtype; the float32 outputs (encoder, cross keys / values) within
   F32_CARD_CPU_RTOL of the CPU's, the bf16 decoder's logits within
   BF16_FIRST_STEP_RTOL.  Printed: parameters, peak memory, prefill
   seconds and rates warm and cold (whisper's decoder tokens and
   encoder frames apart), decode ms/step, the device profile of one
   prefill and 8 decode steps, beside the card's name and power limit;
   the verdict is ``family_failures``, read after phase 11.

15. training every family and the dense LM on a mesh, serving on it — (a)
   whisper-small (8 × 448 tokens over 8 × 1500 float32 frames from
   ``SyntheticLM``: its encoder and cross-attention run in float32
   under bf16 params, as JAX promotes; 6 + 6 of its 12 + 12 layers),
   internvl2-1b (8 × 2048 tokens after 256 patches; 12 of 24 layers)
   and mixtral-8x7b (8 × 2048 tokens, capacity factor 1.25, published
   width, as deep as ``moe_train_depth`` reckons from the card's free
   memory and at most ``MOE_TRAIN_MAX_LAYERS``, printed; the depth cuts
   ``FAMILY_TRAIN_LAYERS`` / ``MOE_TRAIN_MAX_LAYERS`` hold the script's
   time) through ``launch.train.train`` as
   phase 11 (a), bf16 params, 6 steps: flash attention twice a call a
   step (forward and remat's recompute: whisper 2 × 18, internvl2 2 ×
   12, mixtral 2 × layers), no plain attention forward, the plain
   version once a call a step (B5's backward); (b) the three at 1
   layer of published width (whisper 1 + 1; mixtral's ~27 GB of
   float32 state a side, the host's free memory printed first;
   ``FAMILY_CHECK_LAYERS``, the cut printed), float32
   card vs CPU as phase 11 (d) (1 step each:
   ``FAMILY_CHECK_STEPS``, for the script's time), for mixtral also
   step 1's routes: a
   token routed differently must be a near-tie (``route_flip``); (c) a
   (data n, model 1) ``DeviceMesh`` over the n visible cards under NCCL,
   one process a card (``--mesh-child``): smollm-360m at published size
   through ``train(mesh=)``, B5 64 times a step, its step against phase
   11's; 2 float32 layers mesh vs plain within 1e-4; ``compressed_psum``
   over the data dimension bit-equal to its numpy form; a delta-store
   save and ``reshard_from_checkpoint`` bit-equal; then mixtral-8x7b
   (published width and 8 experts, expert parallel, as deep as
   ``moe_train_cut`` reckons, printed), mamba2-130m (12 of 24 layers),
   whisper-small (6 + 6 layers, 8 × 448 tokens over float32 frames) and
   internvl2-1b (12 layers, 256 patches + 2048 tokens; both at (a)'s
   depths) through ``train(mesh=)`` in bf16, 4 steps (B5 2 × its calls,
   B6 2 × 24 a step), their steps beside (a)'s where (a) trained the
   same depth, and float32 mesh vs plain on the card, mixtral 1 layer
   within 2e-4 with the first forward's pairs routed differently
   printed, 1 step, mamba2, whisper (2 + 2) and internvl2 2 layers
   within 1e-4, 2 steps each (``MESH_MODELS``, the cuts printed);
   jamba's reckoning printed (its mesh step needs two cards); then, at
   world 1, each of
   ``MESH_SERVE`` served on the mesh (``models.api.prefill`` /
   ``decode_step``, the caches at ``launch.dryrun.cache_sharding``'s
   placements, whisper's cross caches at the batch rule) and plainly
   from one draw of its weights (``mesh_and_plain``): whisper-small (12
   + 12) at published size, internvl2-1b at 12 of 24 layers,
   smollm-360m at 8 of 32, mamba2-130m at 12 of 24 and mixtral-8x7b at
   4 (``MESH_SERVE_LAYERS``, the cuts printed), jamba-1.5-large's period
   with ``hybrid_distinct_moe``'s experts (or its reckoning printed
   where it does not fit), a prefill of 8 × 2048 (whisper 8 × 416 over
   8 × 1500 float32 frames, internvl2 after 8 × 256 patches) and 32
   greedy steps, counters zeroed around each: every step's logits
   bit-equal to the plain path's, the same launches (B5 / B6 a layer a
   prefill, whisper's 36, none in decode); printed: prefill s (warm,
   cold) and decode ms/step beside the plain path's, peak memory; last
   of all, at world 1, one training step of smollm-360m at that depth
   with the int8 optimizer state (``int8_mesh_step``: 8 × 2048 tokens,
   bf16 params) on the mesh and plainly from the same state: every
   ``q``, every ``scale`` and every parameter bit-equal, B5 twice a
   layer in each; the mesh step runs twice from that state, and both
   its seconds (cold, warm), the plain step's and the warm step's
   ``torch.cuda.max_memory_allocated`` (the counter reset just before
   it) are printed.  Before each model of (c) trains or is served, and
   before the int8 step, the card's memory is read against the start of
   (c) (``memory_readout``): the bytes allocated, those in blocks made
   since, and how much of them lies in tensors the garbage collector
   reaches (by dtype and shape).  Verdicts
   ``train_failures``, ``card_cpu_failures``, ``mesh_failures``, read at
   the end.

16. jamba-1.5-large — the hybrid family at published width over one
   whole period (8 layers: seven Mamba2 mixers and one attention layer
   at offset 4, d 8192, 64 / 8 heads of 128, no positions; an MLP of
   d_ff 24,576 or, every second layer, 16 experts top-2 of d_ff 24,576
   at capacity_factor 1.25; ssm_state 128, headdim 64, expand 2, conv
   4, chunk 256; vocab 65,536), random bf16 weights from a seeded
   generator, memory freed first as in phase 13.  The period's four
   MoE layers are ~77 GB of experts; ``hybrid_distinct_moe`` reckons
   how many get experts of their own (the weights and 18 GiB of
   activations within the free memory; ``--hybrid-distinct``
   overrides), and each later MoE layer routes its own tokens through
   its own router over the last distinct layer's 16 experts (the same
   Parameters), so every FLOP and launch of the period runs.  (a)
   prefill 8 × 2048 and 32 greedy decode steps, counters zeroed around
   each: flash attention once and the SSD scan seven times a prefill,
   nothing else, nothing in decode; (b) one prefill's routing (pairs
   dropped, the fullest expert against the capacity, 2560); (c) bf16
   decode against a fresh forward over sequence 0 at the check-only
   capacity_factor E / k = 8, under phase 13's rules; (d) float32 on
   the card against the CPU at d 1024, 8 / 1 heads of 128, d_ff 3072
   and everything else published (~3.3 GB a side), one prompt of 256
   tokens and 8 steps (DENSE_CHECK_DECODE, the cut printed): logits
   within F32_CARD_CPU_RTOL, the same
   greedy tokens, and every MoE call routing alike or, a token routed
   differently, a near-tie (``route_flip``).  Printed: parameters as
   served and as stored and which layers share experts, peak memory,
   prefill seconds and tokens/s (warm and cold), decode ms/step, the
   device profile of one prefill and of 8 decode steps, beside the
   card's name and power limit; the verdict is ``hybrid_failures``,
   read after phase 11.

17. the dry-run — ``launch.dryrun.run_cell`` traces phase 15 (c)'s
   int8 smollm-360m training cell (the same depth, batch, sequence and
   state dtype, the world-1 mesh, the baseline rules) on fake CUDA
   tensors in a process of its own (``--dryrun-child``, on the fake
   process group; started with phase 15 (c), so that it has ended
   before the int8 steps, and read after it): its peak beside the
   measured ``max_memory_allocated`` of the warm step and their ratio,
   which must lie in [0.5, 2.0] (``DRYRUN_MEMORY_RATIO``), and its flops
   (B5 counted as its plain version, masked scores included) over the
   warm step's seconds as TFLOP/s, beside the card's name and power
   limit and how long before the int8 steps the child ended; the
   verdict is ``dryrun_failures``.

18. gemma-2b, olmo-1b and glm4-9b — the dense family's other
   configurations at published width and depth (gemma-2b: 18 layers, d
   2048, MQA 8 / 1 heads of 256, GeGLU of d_ff 16,384, a tied 256,000
   table; olmo-1b: 16 layers, MHA 16 / 16 of 128, the non-parametric
   LayerNorm, a tied 50,304 table; glm4-9b: 40 layers, d 4096, GQA 32 / 2
   of 128, d_ff 13,696, an untied 151,552 unembedding), one at a time,
   through ``phase_lm`` as phases 5 and 6: bf16 weights from a seeded
   generator, a prefill of 8 × 2048 and 32 greedy steps, B5 18 / 16 / 40
   times a prefill, no other kernel, none in decode; bf16 decode against
   a fresh forward over sequence 0; the float32 card against the CPU as
   deep as keeps a CPU decode step within DENSE_CHECK_STEP_BYTES (glm4 2,
   gemma 4, olmo 6 layers) over DENSE_CHECK_DECODE (8) steps, the cut
   printed; the card's memory allocated before and after each model
   printed, and no more after than before.  The verdict is
   ``dense_failures``, read after phase 11.

19. kimi-k2-1t-a32b — the MoE family at published width (d 7168, 64 /
   8 heads of 112, 384 experts top-8 of d_ff 2048, swiglu, rms, rope
   θ 5e6, an untied 163,840 vocabulary, capacity_factor 1.25), random
   bf16 weights from a seeded generator, memory freed first as in phase
   13.  One layer with its experts and the tables are 38.76 GB, two
   72.83 GB, and (c)'s forward holds a dispatch buffer, the experts'
   outputs and their concatenation of 11.45 GB each: ``kimi_depth``
   reckons from the free memory, as ``hybrid_distinct_moe`` does, how
   many layers keep experts of their own (1), and the layers past them
   route their own tokens through their own routers over that layer's
   384 experts (``hybrid_model``; 0.242 GB a layer), as deep as the
   card holds and at most KIMI_LAYERS (2; ``--lm-layers`` overrides),
   both reckonings printed.  Through ``phase_hybrid``: (a) prefill 8 ×
   2048 and 32 greedy decode steps, counters zeroed around each: flash
   attention once a layer a prefill at head_dim 112 (run padded to
   128), nothing else, nothing in decode; (b) one prefill's routing
   (pairs dropped at capacity 432, some must; the fullest expert); (c)
   bf16 decode of sequence 0 against a fresh forward at the check-only
   capacity_factor E / k = 48, under phase 13's rules; (d) float32 on
   the card against the CPU at one layer, 8 / 1 heads of 112 and the
   widest d_model whose CPU decode step reads at most
   DENSE_CHECK_STEP_BYTES with every expert (``kimi_check_config``: d
   384), everything else published, one prompt of 256 tokens and 8
   steps: logits within F32_CARD_CPU_RTOL, the same greedy tokens, and
   every MoE call routing alike or, a token routed differently, a
   near-tie.  Printed: both reckonings, parameters as served and as
   stored, peak memory, prefill seconds and tokens/s (warm and cold),
   decode ms/step, a decode step's device kernels and the host's share
   of it, the device profile of one prefill and of 8 decode steps, the
   card's memory allocated before and after the model (no more after),
   beside the card's name and power limit; the verdict is
   ``kimi_failures``, read after phase 11.

Phase 10 runs right after phase 4, and phases 7, 8, 9 and 12 after it;
phase 18 runs after phases 5 and 6, phase 14 after phase 18, phase 13
after phase 14, phase 16 after phase 13, phase 19 after phase 16, phase
11 after them, phase 15 then, and phase 17 last.  Phase 15 (c) also
prints the single-card training reckonings with the int8 optimizer
state of jamba's period and of kimi-k2's layer
(``int8_train_reckonings``).
``main`` sets ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``
before the first CUDA allocation, so that memory earlier phases freed
can hold phase 13's, 16's and 19's models.

Phases 3, 4, 7, 8, 9, 10 and 12 zero the launch counters before driving
each session (and each reopen, each driver run) and read them after:
each kernel the layout should use must have launched.
A sample of the answers must equal, bit for bit, those of the same
session built with ``device="cpu"`` from the same ops; triangle counts
are checked against a sparse count of the snapshot.  Phases 5, 6 and 18
zero the counters before the prefill and the decode and read them after
each: one launch of the model's kernel per layer in the prefill, none
of the other kernels, none in decode.  The decode must agree with a
fresh forward over prompt + generated tokens (bf16 tolerance printed),
and the same model in float32 on the card and on the CPU (one prompt of
256 tokens, 32 decode steps) must give close logits and the same greedy
tokens.  For mamba2 the float32 run is repeated on the card with the
plain chunked scan in the kernel's place, the float32 card and CPU
models are read output by output (embeddings, each layer, logits)
against a float64 copy of the same weights, and phase 2 reads the SSD
scan and its plain version against a float64 scan: the witnesses of
where the float32 card–CPU gap comes from.

The second-to-last line is ``{"kernels": [...], "phases": {...}}``; the
last is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# NVIDIA's data-sheet rate for float32 outside the tensor cores, the
# nearest published rate for 32-bit scalar work; the kernels do int32
# compares, atomics and adds, one per in-window entry per query and one
# per output element.
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_FLOPS = 989e12         # H100 SXM dense bf16, NVIDIA data sheet
F32_FLOPS = 67e12                  # float32 outside the tensor cores
# ~0.1 s at the H100's clock: longer than the host takes to enqueue any
# timed run of kernel calls (cuda_ms)
SLEEP_CYCLES = 200_000_000
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 2048, 32
CHECK_PROMPT, CHECK_DECODE = 256, 32
# phase 14: whisper's decoder prompt is Whisper's text context (n_text_ctx
# 448 in openai/whisper's model dimensions) less the LM_DECODE greedy
# steps, so that cache_cap is 448; internvl2's is LM_PROMPT after its 256
# patches
WHISPER_TEXT_CTX = 448
FAMILY_ARCHS = (("whisper-small", WHISPER_TEXT_CTX - LM_DECODE),
                ("internvl2-1b", LM_PROMPT))
# bf16 decode against a fresh bf16 forward over the same tokens, as max
# |Δ logit| / max |logit| per step.  The two paths round differently (a
# [B, 1] matmul against a [1, S] one; the SSM's recurrence against its
# chunked form), and in bf16 each step's differences feed the next
# step's cache and every later layer, so the gap grows along the decode
# while the float32 check below stays tight.  The first step, which
# reads the caches prefill built before any decode rounding feeds back,
# is held to 2^-4; all 32 steps to 2^-2.  (Set after the first run on
# the card, which measured up to 1.5e-2 and 0.16.)
BF16_FIRST_STEP_RTOL = 2.0 ** -4
BF16_DECODE_RTOL = 2.0 ** -2
# float32 card against float32 CPU: max |Δ logit| / max |logit| over
# the prefill and 32 decode steps; the sums run in other orders on the
# two devices (TF32 stays off).  Read on an H100 80GB HBM3 at 700 W:
# smollm-360m 2.4e-6, mamba2-130m 3.9e-5.  mamba2 read 3.1e-4 while the
# CPU's chunked scan formed its in-chunk cumsums in float32: against a
# float64 copy of the model (``float64_drift``) the CPU then sat 8-28x
# farther from float64 than the card, whose kernel forms them in
# float64, at every layer; with the plain scan forming them in float64
# too, card and CPU sit within 0.7-1.8x of each other, layer by layer.
F32_CARD_CPU_RTOL = 1e-4
# the float32 card-vs-CPU checks of phases 5, 6 and 14, and phase 14's
# mixed-dtype promotion check, run at most 6 layers deep (an
# encoder-decoder 6 + 6): their CPU side is host-bound, and at published
# depth they took 13.9 (smollm-360m), 5.0 (mamba2-130m), 11.3
# (whisper-small), 12.7 (internvl2-1b) and 10.2 s (the promotion check)
# on one H100 80GB HBM3 at 700 W (the slowest host measured).  Cut when
# phase 15 (c) began to train and serve whisper-small and internvl2-1b,
# for the script's time
F32_CHECK_LAYERS = 6
PAPER_PARAMS = dict(m_attach=6, lam_extra=2.2, lam_remove=3.61,
                    events_per_unit=8)      # paper Table 3
# phase 11: (a) / (b) / (c) train 8 × 2048 tokens a step for 6 steps;
# (c) saves every 2nd step and fails once at step 3; (d) trains 2 layers
# of each model at full width in float32, 2 × 256 tokens, 3 steps, on
# the card and on the CPU
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 6
CKPT_EVERY, CKPT_FAIL_AT = 2, 3
# (c) trains 2 of mamba2's 24 layers: with phase 15 (c)'s serving the
# whole script read 1120 s at 12 layers (24 layers took ~65 s, 12 ~42
# s, 6 ~32 s on one H100 at 700 W, the slowest host measured, and 3
# layers 25.2 s on a faster one); cut from 6 to 3 when phase 15 (c)
# began to train and serve whisper-small and internvl2-1b, and to 2
# when phase 18 began to serve gemma-2b, olmo-1b and glm4-9b
RECOVERY_LAYERS = 2
CHECK_TRAIN_LAYERS, CHECK_TRAIN_BATCH, CHECK_TRAIN_SEQ = 2, 2, 256
CHECK_TRAIN_STEPS = 3
# float32 training on the card against the CPU: per step, |Δ loss| /
# |loss| and |Δ grad norm| / grad norm, over the 3 steps of (d).  The
# sums run in other orders on the two devices (TF32 stays off), and
# each step's update feeds the next step.  Read on an H100 80GB HBM3 at
# 700 W: smollm-360m 4.7e-7, mamba2-130m 9.9e-6 (its third step's grad
# norm); the first run read mamba2 at 2.2e-5 while the card's initial
# A_log (a log of a linspace, computed on the card) differed from the
# CPU's in the last bit, since fixed (``init_train_state`` builds on
# the CPU and moves).
F32_TRAIN_CARD_CPU_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> int:
    log(f"chip_smoke: FAILED: {msg}")
    return 1


# ---------------------------------------------------------------------------
# Workload: one op stream and one query mix per session
# ---------------------------------------------------------------------------


def make_ops(n_nodes: int, seed: int):
    from repro_torch.core.generate import EvolutionParams, generate_ops
    return generate_ops(n_nodes, EvolutionParams(**PAPER_PARAMS), seed)


def batches(ops, n_batches: int):
    """Split the stream at time-unit boundaries into ``n_batches``."""
    t_max = ops[-1].t
    cuts = [t_max * (i + 1) // n_batches for i in range(n_batches)]
    out, lo = [], 0
    for hi in cuts:
        out.append([(o.op, o.u, o.v, o.t) for o in ops if lo < o.t <= hi])
        lo = hi
    return [b for b in out if b]


def query_mix(t_cur: int, n_nodes: int, dense: bool, seed: int):
    """The mixed batch: (Query kwargs, include in the CPU sample)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vs = [int(x) for x in rng.integers(0, n_nodes // 4, size=12)]
    ts = [max(1, int(t_cur * f)) for f in (0.2, 0.35, 0.5, 0.65, 0.8, 0.95)]
    ta = max(1, int(t_cur * 0.6))        # clustered agg windows
    qs = []
    for i, t in enumerate(ts):
        qs.append((dict(kind="point", scope="node", measure="degree",
                        t_k=t, v=vs[i]), True))
    for i in range(3):
        qs.append((dict(kind="diff", scope="node", measure="degree",
                        t_k=ts[i], t_l=ts[i + 3], v=vs[6 + i]), True))
    for i, agg in enumerate(("mean", "min", "max", "mean")):
        qs.append((dict(kind="agg", scope="node", measure="degree",
                        t_k=ta + i, t_l=ta + i + 7, v=vs[i + 8], agg=agg),
                   True))
    for m, t in (("num_edges", ts[2]), ("num_nodes", ts[3]),
                 ("density", ts[4]), ("avg_degree", ts[1])):
        qs.append((dict(kind="point", scope="global", measure=m, t_k=t),
                   True))
    qs.append((dict(kind="point", scope="global",
                    measure="degree_distribution", t_k=ts[3]), True))
    qs.append((dict(kind="diff", scope="global", measure="num_edges",
                    t_k=ts[0], t_l=ts[5]), True))
    qs.append((dict(kind="agg", scope="global", measure="avg_degree",
                    t_k=ta, t_l=ta + 5, agg="mean"), True))
    qs.append((dict(kind="evolve", scope="global", measure="num_edges",
                    t_k=ts[0], t_l=ts[4], stride=max(1, t_cur // 40)),
               True))
    if dense:
        # dense-only measures: the N² kernel path (not in the CPU sample
        # — O(N³) products on the host; triangles are checked sparsely)
        qs.append((dict(kind="point", scope="global", measure="triangles",
                        t_k=ts[2]), False))
        qs.append((dict(kind="point", scope="global", measure="triangles",
                        t_k=ts[5]), False))
        qs.append((dict(kind="point", scope="global",
                        measure="num_components", t_k=ts[4]), False))
        qs.append((dict(kind="point", scope="node", measure="neighborhood2",
                        t_k=ts[3], v=vs[0]), False))
    return qs


def sweeps(t_cur: int, v: int):
    lo = max(1, t_cur // 5)
    stride = max(1, t_cur // 48)
    return [dict(measure="avg_degree", t_lo=lo, t_hi=t_cur, stride=stride),
            dict(measure="degree", t_lo=lo, t_hi=t_cur, stride=stride, v=v),
            dict(measure="degree_distribution", t_lo=lo, t_hi=t_cur,
                 stride=stride * 4)]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn`` over ``reps`` calls.  The
    card sleeps first while the host enqueues the calls, so a call the
    host launches more slowly than the card runs it is timed on the
    card (CUDA events), not at the host's launch rate; the host's own
    time to return from each call while the card sleeps is the second
    number (a call that synchronizes still waits for the sleep: its
    device time is as before and its host time holds the sleep)."""
    import torch
    fn()                                   # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def in_window(t_col, lo, hi) -> int:
    """Σ over queries of the entries whose time falls in (lo_q, hi_q]
    — the atomics this run's data needs."""
    t = t_col.view(1, -1)
    return int(((t > lo.view(-1, 1)) & (t <= hi.view(-1, 1))).sum())


def delta_apply_design(ent, tst, ta, tq) -> dict:
    """What B1's design is about, from the bucketing: entries per 64×64
    tile and, per query, the tiles with no entry in its window (they
    write the anchor straight out)."""
    import torch

    from repro_torch.kernels.delta_apply.ref import entry_tiles
    counts = (tst[1:] - tst[:-1]).to(torch.int64)
    t = ent[:, 1].view(1, -1)
    win = ((t > torch.minimum(ta, tq).view(-1, 1))
           & (t <= torch.maximum(ta, tq).view(-1, 1)))
    per = torch.zeros((win.shape[0], counts.numel()), dtype=torch.int64,
                      device=ent.device)
    per.index_add_(1, entry_tiles(tst), win.to(torch.int64))
    empty = (per == 0).sum(1).tolist()
    return dict(tiles=counts.numel(),
                entries_per_tile_mean=float(counts.double().mean()),
                entries_per_tile_max=int(counts.max()),
                tiles_without_window_entry=empty,
                tile_queries_without_window_entry=sum(empty))


def edge_delta_apply_design(ent, tst, ta, tq) -> dict:
    """What B2's design is about, from the bucketing: entries per
    512-slot tile, the warps that share a tile (one per query, up to
    four), the blocks (8 warps each) and the entries of the heaviest,
    and, per query, the tiles with no entry in its window (their warp
    writes the anchor straight out)."""
    import torch

    from repro_torch.kernels.delta_apply.ref import entry_tiles
    from repro_torch.kernels.edge_delta_apply import WARPS
    counts = (tst[1:] - tst[:-1]).to(torch.int64)
    tiles = counts.numel()
    q = tq.numel()
    groups = 4 if q >= 4 else (2 if q >= 2 else 1)
    per_block = WARPS // groups
    blocks = -(-tiles // per_block)
    per_block_entries = torch.zeros(blocks * per_block, dtype=torch.int64,
                                    device=counts.device)
    per_block_entries[:tiles] = counts
    per_block_entries = per_block_entries.view(blocks, per_block).sum(1)
    t = ent[:, 0].view(1, -1)
    win = ((t > torch.minimum(ta, tq).view(-1, 1))
           & (t <= torch.maximum(ta, tq).view(-1, 1)))
    per = torch.zeros((win.shape[0], tiles), dtype=torch.int64,
                      device=ent.device)
    per.index_add_(1, entry_tiles(tst), win.to(torch.int64))
    empty = (per == 0).sum(1).tolist()
    return dict(tiles=tiles,
                entries_per_tile_mean=float(counts.double().mean()),
                entries_per_tile_max=int(counts.max()),
                warps_per_tile=groups, blocks=blocks,
                heaviest_block_entries=int(per_block_entries.max()),
                blocks_without_entry=int((per_block_entries == 0).sum()),
                tiles_without_window_entry=empty,
                tile_queries_without_window_entry=sum(empty))


def sweep_design(tst, n_events: int) -> dict:
    """What B4's and B3's design is about, from the bucketing and the
    work list their kernel's blocks derive from it: events per 256-node
    tile, the blocks they were cut into (``rows_per_query`` counts the
    surplus rows of the list too, whose blocks exit at once).  On the
    card the list is the work kernel's (the code the blocks run to find
    their rows), held bit for bit against its plain version."""
    import torch

    from repro_torch.kernels.evolve_sweep import sweep, sweep_work_ref
    counts = (tst[1:] - tst[:-1]).to(torch.int64)
    rows = sweep.sweep_work(tst, n_events)
    if not torch.equal(rows, sweep_work_ref(tst, n_events, sweep.CHUNK)):
        raise AssertionError("the series' work list disagrees with "
                             "its plain version")
    real = rows[rows[:, 0] >= 0]
    split = real[real[:, 3] >= 0, 0]
    sizes = (real[:, 2] - real[:, 1]).to(torch.int64)
    return dict(tiles=counts.numel(),
                events_per_tile_mean=float(counts.double().mean()),
                events_per_tile_max=int(counts.max()), chunk=sweep.CHUNK,
                blocks_per_query=int(sizes.numel()),
                rows_per_query=rows.shape[0],
                split_tiles=int(torch.unique(split).numel()),
                heaviest_block_events=int(sizes.max()))


def kernel_cases(dense_store, edge_store, dense_q, edge_q, seed: int):
    """The four graph kernels' inputs as the sessions' groups build them
    (timed), then B1's and B4's other paths on the same data: B1 with a
    per-query anchor and windows both ways, with a ``row_mask``, and at
    N = 1000 and 1008 (ragged tiles, bytes and 16-byte words); B4 with
    four sweeps of different windows, at the dense session's N, and with
    B past the shared-memory limit (global nets).  Every case is held
    bit for bit against its plain version."""
    import torch

    from repro_torch.core.reconstruct import (reconstruct_dense_many,
                                              reconstruct_edge_many,
                                              window_of)
    from repro_torch.kernels.degree_series import (TILE as DS_TILE,
                                                   degree_series_kernel,
                                                   degree_series_ref)
    from repro_torch.kernels.delta_apply import (TILE as DA_TILE,
                                                 bucket_ops, delta_apply,
                                                 delta_apply_ref)
    from repro_torch.kernels.edge_delta_apply import (
        TILE as EA_TILE, bucket_slot_ops, edge_delta_apply,
        edge_delta_apply_ref)
    from repro_torch.kernels.evolve_sweep import (TILE as SW_TILE,
                                                  bucket_sweep_events,
                                                  sweep_series,
                                                  sweep_series_ref)
    from repro_torch.kernels.evolve_sweep.ops import _start_state

    dev = dense_store.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    def b1_case(adj, d, ta, tq, row_mask=None, timed=False, what="",
                row0=0, whole=None):
        r, n = adj.shape[-2:]
        ent, tst = bucket_ops(d, n, *window_of(ta, tq), row0=row0,
                              n_rows=r)
        q = tq.numel()
        lo, hi = torch.minimum(ta, tq), torch.maximum(ta, tq)
        block = f" R={r} row0={row0}" if r != n else ""
        return dict(
            name="delta_apply", route="cuda",
            source="src/repro_torch/kernels/delta_apply/delta_apply.cu",
            replaces="src/repro/kernels/delta_apply/delta_apply.py:52",
            kernel=lambda: delta_apply(adj, ent, tst, ta, tq, row_mask),
            plain=lambda: delta_apply_ref(adj, ent, tst, ta, tq, row_mask,
                                          DA_TILE),
            bytes=nbytes(adj, ent, tst, ta, tq) + q * r * n
            + (nbytes(row_mask) if row_mask is not None else 0),
            ops=in_window(ent[:, 1], lo, hi) + q * r * n, timed=timed,
            design=delta_apply_design(ent, tst, ta, tq), whole=whole,
            shape=f"Q={q} N={n}{block} entries={ent.shape[0]}{what}")

    def once(fn):
        """``fn()``, computed at the first call and kept: the whole-graph
        kernel output that every block case of a group is sliced from."""
        memo = []

        def get():
            if not memo:
                memo.append(fn())
            return memo[0]
        return get

    def b4_case(deg0, d, t_lo, widths, stride, nb, timed=False, what=""):
        q, n = deg0.shape
        t_last = t_lo + (widths - 1) * stride
        ev, tst = bucket_sweep_events(d, n, int(t_lo.min()),
                                      int(t_last.max()))
        return dict(
            name="sweep_series", route="cuda",
            source="src/repro_torch/kernels/evolve_sweep/sweep.cu",
            replaces="src/repro/kernels/evolve_sweep/sweep.py:100",
            kernel=lambda: sweep_series(deg0, ev, tst, t_lo, t_last, stride,
                                        nb),
            plain=lambda: sweep_series_ref(deg0, ev, tst, t_lo, t_last,
                                           stride, nb, SW_TILE),
            bytes=nbytes(deg0, ev, tst, t_lo, t_last) + q * nb * n * 4,
            ops=in_window(ev[:, 0], t_lo, t_last) + q * nb * n,
            timed=timed, design=sweep_design(tst, ev.shape[0]),
            shape=f"Q={q} B={nb} N={n} events={ev.shape[0]}{what}")

    def b2_case(anchor, d, ta, tq, timed=False, one_query=False, what="",
                slot0=None, whole=None):
        e = anchor.shape[-1]
        ent, tst = bucket_slot_ops(d, e, *window_of(ta, tq),
                                   slot0=slot0 or 0)
        q = tq.numel()
        lo, hi = torch.minimum(ta, tq), torch.maximum(ta, tq)
        # the same buckets at Q = 1: does the time still scale with Q?
        parts = ({"one_query": lambda: edge_delta_apply(
            anchor if anchor.dim() == 1 else anchor[:1], ent, tst, ta[:1],
            tq[:1])} if one_query else None)
        return dict(
            name="edge_delta_apply", route="cuda",
            source="src/repro_torch/kernels/edge_delta_apply/"
                   "edge_delta_apply.cu",
            replaces="src/repro/kernels/edge_delta_apply/"
                     "edge_delta_apply.py:53",
            kernel=lambda: edge_delta_apply(anchor, ent, tst, ta, tq),
            plain=lambda: edge_delta_apply_ref(anchor, ent, tst, ta, tq,
                                               EA_TILE),
            # the anchor (shared, or one per query), entries, tile starts
            # and times read once; Q outputs written once
            bytes=nbytes(anchor, ent, tst, ta, tq) + q * e,
            ops=in_window(ent[:, 0], lo, hi) + q * e, timed=timed,
            design=edge_delta_apply_design(ent, tst, ta, tq), parts=parts,
            whole=whole,
            shape=f"Q={q} E={e}"
                  f"{'' if slot0 is None else f' slot0={slot0}'} "
                  f"entries={ent.shape[0]}"
                  f"{' per-query anchors' if anchor.dim() == 2 else ''}"
                  f"{what}")

    def b3_case(deg_cur, d, t_k, nb, timed=False, what="", row0=0,
                whole=None):
        n = deg_cur.shape[0]
        ev, tst = bucket_sweep_events(d, n, t_k, row0=row0)
        return dict(
            name="degree_series", route="cuda",
            source="src/repro_torch/kernels/degree_series/degree_series.cu",
            replaces="src/repro/kernels/degree_series/degree_series.py:57",
            kernel=lambda: degree_series_kernel(deg_cur, ev, tst, t_k, nb),
            plain=lambda: degree_series_ref(deg_cur, ev, tst, t_k, nb,
                                            DS_TILE),
            bytes=nbytes(deg_cur, ev, tst) + nb * n * 4,
            ops=int((ev[:, 0] > t_k).sum()) + nb * n, timed=timed,
            design=sweep_design(tst, ev.shape[0]), whole=whole,
            shape=f"B={nb} N={n}{f' row0={row0}' if whole else ''} "
                  f"events={ev.shape[0]}{what}")

    # B1: a dense two-phase point group (the dense-only global measures)
    ts = sorted({q["t_k"] for q, _ in dense_q
                 if q["measure"] in ("triangles", "num_components")})
    t_cur = dense_store.t_cur
    tq = i32(ts)
    ta = torch.full_like(tq, t_cur)
    d = dense_store.delta_view().window_delta(min(ts), t_cur)
    n = dense_store.n_cap
    adj = dense_store.current.adj
    cases.append(b1_case(adj, d, ta, tq, timed=True))
    # B1 on row blocks, as a row-sharded group runs it: the same windows
    # over four blocks of N/4 rows, each also held against the rows of
    # the whole-graph kernel's output
    whole_b1 = once(lambda: delta_apply(
        adj, *bucket_ops(d, n, *window_of(ta, tq)), ta, tq))
    rb = n // 4
    for row0 in range(0, n, rb):
        cases.append(b1_case(
            adj[row0:row0 + rb], d, ta, tq, timed=True, row0=row0,
            whole=lambda r0=row0: whole_b1()[:, r0:r0 + rb],
            what=" row block"))

    # B2: an edge two-phase point group (node degree at six times)
    ts2 = sorted({q["t_k"] for q, _ in edge_q if q["kind"] == "point"})
    t_cur_e = edge_store.t_cur
    tq2 = i32(ts2)
    ta2 = torch.full_like(tq2, t_cur_e)
    d = edge_store.delta_view().window_delta(min(ts2), t_cur_e)
    cur = edge_store.current_edge_snapshot()
    cases.append(b2_case(cur.emask, d, ta2, tq2, timed=True, one_query=True))
    # B2 on slot blocks, as a slot-sharded group runs it: E/4 at each
    # slot0, each also held against the whole-mask kernel's slots
    whole_b2 = once(lambda: edge_delta_apply(
        cur.emask, *bucket_slot_ops(d, cur.e_cap, *window_of(ta2, tq2)),
        ta2, tq2))
    sb = cur.e_cap // 4
    for slot0 in range(0, cur.e_cap, sb):
        cases.append(b2_case(
            cur.emask[slot0:slot0 + sb], d, ta2, tq2, timed=True,
            slot0=slot0, whole=lambda s0=slot0: whole_b2()[:, s0:s0 + sb],
            what=" slot block"))
    # a ragged split: blocks neither a multiple of 16 slots nor of the
    # tile, the second starting off a 16-byte boundary
    sr = cur.e_cap // 3 + 5
    for slot0, w in ((0, sr), (sr, sr), (2 * sr, cur.e_cap - 2 * sr)):
        cases.append(b2_case(
            cur.emask[slot0:slot0 + w], d, ta2, tq2, slot0=slot0,
            whole=lambda s0=slot0, w=w: whole_b2()[:, s0:s0 + w],
            what=" ragged slot block"))

    # B3: the hybrid agg group's shared degree series
    aggs = [q for q, _ in edge_q if q["kind"] == "agg"
            and q["scope"] == "node"]
    t0 = min(q["t_k"] for q in aggs)
    w_total = 1 << (max(q["t_l"] for q in aggs) - t0).bit_length()
    d3 = edge_store.delta_view().window_delta(t0, None)
    deg = cur.degrees()
    cases.append(b3_case(deg, d3, t0, w_total, timed=True))

    # B4: a sweep group's degree series (the session's degree sweep)
    def sweep_start(store, cur_g, t_los, dense):
        view = store.delta_view()
        d_rec = view.window_delta(int(t_los.min()), store.t_cur,
                                  merged=True)
        recon = reconstruct_dense_many if dense else reconstruct_edge_many
        return _start_state(recon(cur_g, d_rec, store.t_cur, t_los),
                            dense)[0]

    def sweep_shape(store):
        sw = sweeps(store.t_cur, 0)[1]
        lo, hi, stride = sw["t_lo"], sw["t_hi"], sw["stride"]
        width = (hi - lo) // stride + 1
        return lo, stride, width, 1 << (width - 1).bit_length()

    lo, stride, width, nb = sweep_shape(edge_store)
    t_lo = i32([lo])
    deg0 = sweep_start(edge_store, cur, t_lo, dense=False)
    d4 = edge_store.delta_view().window_delta(lo, lo + (width - 1) * stride)
    cases.append(b4_case(deg0, d4, t_lo, i32([width]), stride, nb,
                         timed=True))

    # --- recovery's shapes: Q = 1 over the whole log, (0, t_cur], from
    # the empty graph, as persist/recovery.py rebuilds ``current`` ---
    cases.append(b1_case(torch.zeros_like(adj), dense_store.delta(),
                         i32([0]), i32([t_cur]), timed=True,
                         what=" recovery: empty anchor, whole log"))
    e_reg = edge_store.edge_graph().e_cap
    cases.append(b2_case(torch.zeros(e_reg, dtype=torch.bool, device=dev),
                         edge_store.delta(), i32([0]), i32([t_cur_e]),
                         timed=True,
                         what=" recovery: empty anchor, whole log"))

    # --- B1's other paths: per-query anchors, windows both ways ---
    tq_a = i32([ts[0] - max(1, ts[0] // 3), ts[2], t_cur])
    ta_a = i32(ts)                       # back, forward, forward
    anchors = delta_apply_ref(adj, *bucket_ops(d, n, *window_of(ta, tq)),
                              ta, tq, None, DA_TILE)
    d1 = dense_store.delta_view().window_delta(1, t_cur)
    cases.append(b1_case(anchors, d1, ta_a, tq_a,
                         what=" per-query anchors, windows both ways"))
    # a row_mask (partial reconstruction), main windows
    rm = torch.rand((len(ts), n), generator=gen, device=dev) < 0.03
    cases.append(b1_case(adj, d, ta, tq, row_mask=rm, what=" row_mask"))
    # ragged tiles: N = 1000 moves bytes, N = 1008 16-byte words with a
    # partial last tile; a row_mask and windows both ways
    ta_r, tq_r = i32([t_cur, ts[0], ts[0]]), i32([ts[1], ts[2], 1])
    for nr in (1000, 1008):
        sub = adj[:nr, :nr].contiguous()
        rm_r = torch.rand((3, nr), generator=gen, device=dev) < 0.2
        cases.append(b1_case(sub, d1, ta_r, tq_r,
                             row_mask=rm_r if nr == 1008 else None,
                             what=" ragged" + (" row_mask" if nr == 1008
                                               else "")))
    # ragged row blocks: N = 1000 over 8 shards, 125 rows a block (the
    # last tile row of each is a pad band the next block's entries must
    # not reach), against the whole 1000 × 1000 kernel output's rows
    sub = adj[:1000, :1000].contiguous()
    whole_r = once(lambda: delta_apply(
        sub, *bucket_ops(d1, 1000, *window_of(ta_r, tq_r)), ta_r, tq_r))
    for row0 in range(0, 1000, 125):
        cases.append(b1_case(
            sub[row0:row0 + 125], d1, ta_r, tq_r, row0=row0,
            whole=lambda r0=row0: whole_r()[:, r0:r0 + 125],
            what=" ragged row block"))

    # --- B4's other paths ---
    # four sweeps of different windows at the edge session's N
    t_los = i32([lo, lo + stride // 2, 2 * lo, lo + 7 * stride])
    widths = i32([width, width // 2, 17, 5])
    deg0q = sweep_start(edge_store, cur, t_los, dense=False)
    d4q = edge_store.delta_view().window_delta(
        lo, int((t_los + (widths - 1) * stride).max()))
    cases.append(b4_case(deg0q, d4q, t_los, widths, stride, nb,
                         what=" four windows"))
    # the dense session's N, one sweep and two
    lo_d, stride_d, width_d, nb_d = sweep_shape(dense_store)
    dcur = dense_store.current
    for t_los_d in (i32([lo_d]), i32([lo_d, 2 * lo_d])):
        deg0d = sweep_start(dense_store, dcur, t_los_d, dense=True)
        d4d = dense_store.delta_view().window_delta(
            lo_d, lo_d + (width_d - 1) * stride_d)
        widths_d = torch.full_like(t_los_d, width_d)
        widths_d[1:] = width_d // 2
        cases.append(b4_case(deg0d, d4d, t_los_d, widths_d, stride_d, nb_d))
    # B = 512: the packed net (B/2 × 256 × 4 bytes) past 226 KB of shared
    # memory, so every tile's net is in global scratch
    stride_s = max(1, (dense_store.t_cur - lo_d) // 500)
    t_lo_s = i32([lo_d])
    deg0s = sweep_start(dense_store, dcur, t_lo_s, dense=True)
    d4s = dense_store.delta_view().window_delta(lo_d, dense_store.t_cur)
    cases.append(b4_case(deg0s, d4s, t_lo_s, i32([500]), stride_s, 512,
                         what=" global nets"))

    # --- B2's other paths ---
    # per-query anchors (the agg-diff path) with windows both ways
    ta_q = i32(ts2[1:4])
    tq_q = i32([ts2[0], ts2[4], t_cur_e])          # back, forward, forward
    d2 = edge_store.delta_view().window_delta(1, t_cur_e)
    anchors2 = edge_delta_apply_ref(
        cur.emask, *bucket_slot_ops(d2, cur.e_cap, ts2[1], t_cur_e),
        torch.full_like(ta_q, t_cur_e), ta_q, EA_TILE)
    cases.append(b2_case(anchors2, d2, ta_q, tq_q,
                         what=", windows both ways"))
    # the dense session's slot layout (its registered slots, e_cap a
    # power of two), at its point-query times
    dts = sorted({q["t_k"] for q, _ in dense_q if q["kind"] == "point"})
    dcur_e = dense_store.current_edge_snapshot()
    cases.append(b2_case(
        dcur_e.emask, dense_store.delta_view().window_delta(min(dts), t_cur),
        torch.full((len(dts),), t_cur, dtype=torch.int32, device=dev),
        i32(dts), what=" (dense session)"))
    # a ragged E (not a multiple of 16, of the tile or of the block's
    # 4096 slots), a shared anchor at an earlier time, windows both ways
    e_r = cur.e_cap // 2 + 4099
    t_mid = ts2[2]
    anchor_r = edge_delta_apply_ref(
        cur.emask, *bucket_slot_ops(d2, cur.e_cap, t_mid, t_cur_e),
        i32([t_cur_e]), i32([t_mid]), EA_TILE)[0, :e_r].contiguous()
    cases.append(b2_case(anchor_r, d2, torch.full((3,), t_mid,
                                                  dtype=torch.int32,
                                                  device=dev),
                         i32([ts2[0], ts2[4], t_cur_e]), what=" ragged"))

    # --- B3's other paths ---
    # B = 512: the packed net past 226 KB of shared memory, every tile's
    # net in global scratch (the dense session's N)
    t_k_s = max(1, dense_store.t_cur - 500)
    cases.append(b3_case(dense_store.current.degrees(),
                         dense_store.delta_view().window_delta(t_k_s, None),
                         t_k_s, 512, what=" global nets"))
    # a ragged N (the last node tile partial)
    n_r = cur.n_cap - 100
    cases.append(b3_case(deg[:n_r].contiguous(), d3, t0, w_total,
                         what=" ragged"))
    # four node blocks of N/4 (the glue of a node-sharded series), each
    # against the whole kernel's rows
    n_b = deg.shape[0] // 4
    whole3 = once(lambda: degree_series_kernel(
        deg, *bucket_sweep_events(d3, deg.shape[0], t0), t0, w_total))
    for row0 in range(0, deg.shape[0], n_b):
        cases.append(b3_case(deg[row0:row0 + n_b].contiguous(), d3, t0,
                             w_total, row0=row0,
                             whole=lambda r0=row0: whole3()[:, r0:r0 + n_b],
                             what=" node block"))
    return cases


def _compare(out_k, out_p, tol=None) -> tuple[float, float]:
    """(max |kernel − plain|, max over elements of |kernel − plain| /
    allowed) over the kernel's outputs (a tensor or a tuple of tensors).
    ``tol(plain)`` gives the allowed difference, a number or a tensor of
    the output's shape, or a tuple of those, one per output; without
    ``tol`` the outputs must be equal, integers compared exactly."""
    import torch
    outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
    outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
    allowed = tol(out_p) if tol else 0.0
    if not isinstance(allowed, tuple):
        allowed = (allowed,) * len(outs_p)
    err = share = 0.0
    for a, b, lim in zip(outs_k, outs_p, allowed):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"kernel {tuple(a.shape)} {a.dtype} vs "
                                 f"plain {tuple(b.shape)} {b.dtype}")
        if not a.numel():
            continue
        if a.dtype.is_floating_point:
            a, b = a.float(), b.float()
            # a NaN or an infinity that the plain value does not share
            # counts as an infinite difference (max() skips NaN)
            diff = torch.where(a == b, 0.0, (a - b).abs().nan_to_num(
                nan=math.inf, posinf=math.inf))
        else:
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, float(diff.max()))
        if tol:
            share = max(share, float(torch.where(
                diff == 0, 0.0, diff / lim).nan_to_num(
                    nan=math.inf, posinf=math.inf).max()))
        elif err:
            share = float("inf")
    return err, share


def phase_kernels(cases) -> list[dict]:
    """Each case: kernel against plain version (``tol``: the allowed
    difference as ``_compare`` takes it, or None for bit-exact), then,
    unless ``timed`` is False, timed beside its bound and, where one
    PyTorch call computes the same function (``library``), that call.
    A case with ``truth`` (the same function in float64) also reads
    kernel and plain version against it; ``design`` (counts from the
    kernel's inputs) is printed and kept with the row, and each of
    ``parts`` (a piece of the kernel's launch, alone) is timed with
    it.  A timed kernel's row holds the host's time per call beside
    the card's."""
    import torch
    rows = []
    for c in cases:
        out_k = c["kernel"]()
        torch.cuda.synchronize()
        out_p = c["plain"]()
        torch.cuda.synchronize()
        err, share = _compare(out_k, out_p, c.get("tol"))
        tol_text = c.get("tol_text", "bit-exact")
        if c.get("whole") is not None:
            # a block case: also the block of the whole-graph output
            if not torch.equal(out_k, c["whole"]()):
                raise AssertionError(f"{c['name']} ({c['shape']}) differs "
                                     "from the whole-graph kernel's block")
            tol_text += ", equal to the whole-graph kernel's block"
        extra = {}
        if c.get("library"):
            extra["library_max_abs_err"] = _compare(c["library"](), out_p)[0]
        if c.get("truth"):
            truth = c["truth"]()
            extra["kernel_vs_float64"] = _compare(out_k, truth)[0]
            extra["plain_vs_float64"] = _compare(out_p, truth)[0]
            extra["max_abs_float64"] = max(float(t.abs().max())
                                           for t in truth)
            del truth
        del out_k, out_p
        timed = c.get("timed", True)
        ms, host_ms = cuda_ms(c["kernel"], 20) if timed else (None, None)
        plain_ms = cuda_ms(c["plain"], 3)[0] if timed else None
        library_ms = (cuda_ms(c["library"], 20)[0]
                      if timed and c.get("library") else None)
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / c.get("rate", SCALAR_OPS_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows.append(dict(name=c["name"], route=c["route"],
                         source=c["source"], replaces=c["replaces"],
                         max_abs_err=err, ms=ms, host_ms=host_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations", library_ms=library_ms,
                         bytes=c["bytes"], ops=c["ops"],
                         shape=c["shape"], tolerance=tol_text,
                         tolerance_share=share, **extra))
        if c.get("design"):
            rows[-1]["design"] = c["design"]
        parts = ""
        if timed and c.get("parts"):
            rows[-1]["parts"] = {}
            for name, fn in c["parts"].items():
                p_ms, p_host = cuda_ms(fn, 20)
                rows[-1]["parts"][name] = dict(ms=p_ms, host_ms=p_host)
                parts += f"  {name} {p_ms:.4f} ms (host {p_host:.4f} ms)"
        lib = f"  library {library_ms:.4f} ms" if library_ms else ""
        times = (f"{ms:.4f} ms (host {host_ms:.4f} ms){parts}  plain "
                 f"{plain_ms:.4f} ms{lib}" if timed else "untimed")
        design = "".join(f"  {k} {v}" for k, v in
                         c.get("design", {}).items())
        print(f"kernel {c['name']}: {c['shape']}  {times}  bound "
              f"{bound_ms:.4f} ms ({rows[-1]['bound_by']})  max_abs_err "
              f"{err:.3g}, {share:.3g} of the tolerance ({tol_text})"
              + "".join(f"  {k} {v:.3g}" for k, v in extra.items())
              + design, flush=True)
        if share > 1:
            raise AssertionError(f"{c['name']} ({c['shape']}) disagrees "
                                 f"with its plain version (max abs err "
                                 f"{err}, {share:.3g} of the tolerance)")
        torch.cuda.empty_cache()
    return rows


def main_rows(rows: list[dict]) -> list[dict]:
    """One row per kernel, at its main-path shape (its first case); the
    other shapes of a kernel go with it under "cases"."""
    kernels = []
    for r in rows:
        first = next((k for k in kernels if k["name"] == r["name"]), None)
        if first is None:
            kernels.append(r)
        else:
            first.setdefault("cases", []).append(r)
    return kernels


def attention_case(randn, b, hq, hkv, sq, skv, d, dtype, causal, window,
                   kv_len) -> dict:
    """Flash attention on seeded random inputs, beside its plain version
    and ``scaled_dot_product_attention``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    # [B, S, H, D] activations seen through [B, H, S, D] views, as
    # models/attention.py hands them over
    q = randn(b, sq, hq, d, dtype=dtype).transpose(1, 2)
    k = randn(b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = randn(b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    scale = d ** -0.5
    i = np.arange(sq)
    hi = np.full(sq, (kv_len or skv) - 1)
    if causal:
        hi = np.minimum(hi, i)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    pairs = int(np.maximum(0, hi - lo + 1).sum()) * b * hq
    # the library yardstick: k / v repeated to Hq heads, and the mask as
    # a boolean attn_mask wherever is_causal alone does not say it (a
    # full non-causal case, as whisper's encoder and cross-attention,
    # needs none: an all-true mask would only send the library off its
    # fast path)
    kr = k.repeat_interleave(hq // hkv, 1)
    vr = v.repeat_interleave(hq // hkv, 1)
    mask = None
    # a window that covers every key (mixtral's 4096 over 2048) masks
    # nothing: the library then takes its causal path, without a mask
    lib_window = None if window and window >= skv else window
    if lib_window or kv_len is not None:
        qp = torch.arange(sq, device="cuda")[:, None]
        kp = torch.arange(skv, device="cuda")[None, :]
        mask = kp < (kv_len or skv)
        if causal:
            mask = mask & (kp <= qp)
        if lib_window:
            mask = mask & (kp > qp - lib_window)

    def library():
        return F.scaled_dot_product_attention(
            q, kr, vr, attn_mask=mask, is_causal=causal and mask is None,
            scale=scale)
    bf16 = dtype == torch.bfloat16
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:93",
        kernel=lambda: flash_attention(q, k, v, causal, window, scale,
                                       kv_len),
        plain=lambda: attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale, kv_len=kv_len),
        library=library,
        bytes=nbytes(q, k, v, q), ops=4 * d * pairs,
        rate=BF16_TENSOR_FLOPS if bf16 else F32_FLOPS,
        # bf16: kernel and plain version both sum in float32 and round
        # once, so they may differ by one bf16 ulp of the plain value
        # (<= 2^-7·|p|); 2^-12 covers the float32 sums' own rounding
        # where |p| is near 0
        tol=(lambda out: 2.0 ** -7 * out.float().abs() + 2.0 ** -12)
        if bf16 else (lambda out: 3e-5),
        tol_text="|k-p| <= 2^-7*|p| + 2^-12 per element (bf16: one ulp of "
                 "the plain value)" if bf16
        else "3e-5 abs (f32, sums in another order)",
        shape=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"kv_len={kv_len}")


def ssd_case(randn, b, s, h, p, n, chunk, with_state0: bool) -> dict:
    """The SSD scan on seeded random inputs, a and dt as the model makes
    them; ``with_state0``: a prefill that continues a cache, whose state
    is the final state of an earlier scan (as ``models/ssm.py`` passes
    it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    def inputs():
        return (randn(b, s, h, p), F.softplus(randn(b, s, h)),
                randn(b, s, n), randn(b, s, n))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    state0 = None
    if with_state0:
        x0, dt0, b0, c0 = inputs()
        state0 = ssd_chunked(x0, dt0, a, b0, c0, chunk)[1]
        del x0, dt0, b0, c0
    x, dt, bm, cm = inputs()
    nc = s // chunk
    # per (batch, head, chunk) score·(dt·x), C·stateᵀ and the state
    # update; C·Bᵀ once per (batch, chunk), as the kernel forms it (B and
    # C are one group shared by every head)
    ops = (b * h * nc * (chunk * (chunk + 1) * p + 4 * chunk * p * n)
           + b * nc * chunk * (chunk + 1) * n)
    s0_64 = (state0.double() if with_state0 else
             torch.zeros((b, h, p, n), dtype=torch.float64, device="cuda"))
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:59",
        kernel=lambda: ssd_scan(x, dt, a, bm, cm, chunk, state0),
        plain=lambda: ssd_chunked(x, dt, a, bm, cm, chunk, state0),
        truth=lambda: tuple(t.float() for t in ssd_chunked(
            x.double(), dt.double(), a.double(), bm.double(), cm.double(),
            chunk, s0_64)),
        library=None,
        bytes=nbytes(x, dt, a, bm, cm, x) + b * h * p * n * 4
        * (2 if with_state0 else 1), ops=ops,
        rate=F32_FLOPS,
        tol=lambda out: 5e-5 * max(float(t.abs().max()) for t in out),
        tol_text="5e-5 x max|plain| (f32, sums over a chunk in another "
                 "order; y and final state)",
        shape=f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} "
              f"state0={'nonzero' if with_state0 else 'zero'}")


def lm_kernel_cases(seed: int):
    """Flash attention and the SSD scan on seeded random inputs: the
    main-path shape of each first (smollm-360m / mamba2-130m prefill),
    then flash attention at the shapes phases 13, 14, 15, 16 and 18 give
    it, kimi-k2's prefill (head dim 112) and the other head dims and
    masks it takes, and the scan continuing a cache and at phase 16's
    shape."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    wp = WHISPER_TEXT_CTX - LM_DECODE                 # whisper's prompt
    cases = [attention_case(randn, *args) for args in (
        (LM_BATCH, 15, 5, LM_PROMPT, LM_PROMPT, 64, bf16, True, None,
         None),                                       # smollm-360m prefill
        (1, 32, 2, 512, 512, 128, bf16, True, None, None),   # glm4-9b heads
        (LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128, bf16, True, 4096,
         None),                                       # mixtral-8x7b prefill
        (LM_BATCH, 12, 12, 1500, 1500, 64, bf16, False, None,
         None),                                       # whisper encoder
        (LM_BATCH, 12, 12, wp, 1500, 64, bf16, False, None,
         None),                                       # whisper cross
        (LM_BATCH, 12, 12, wp, wp, 64, bf16, True, None,
         None),                                       # whisper decoder self
        (LM_BATCH, 14, 2, 256 + LM_PROMPT, 256 + LM_PROMPT, 64, bf16, True,
         None, None),                                 # internvl2-1b prefill
        (LM_BATCH, 64, 8, LM_PROMPT, LM_PROMPT, 112, bf16, True, None,
         None),             # kimi-k2 prefill: D 112, run padded to 128 (C9)
        (LM_BATCH, 64, 8, LM_PROMPT, LM_PROMPT, 128, bf16, True, None,
         None),                                       # jamba-1.5-large prefill
        (LM_BATCH, 12, 12, 1500, 1500, 64, f32, False, None,
         None),                       # whisper encoder, training: f32 frames
        (LM_BATCH, 12, 12, WHISPER_TEXT_CTX, 1500, 64, f32, False, None,
         None),                                       # whisper cross, training
        (LM_BATCH, 12, 12, WHISPER_TEXT_CTX, WHISPER_TEXT_CTX, 64, bf16,
         True, None, None),                           # whisper self, training
        (LM_BATCH, 8, 1, LM_PROMPT, LM_PROMPT, 256, bf16, True, None,
         None),                                       # gemma-2b prefill
        (LM_BATCH, 16, 16, LM_PROMPT, LM_PROMPT, 128, bf16, True, None,
         None),                                       # olmo-1b prefill
        (LM_BATCH, 32, 2, LM_PROMPT, LM_PROMPT, 128, bf16, True, None,
         None),                                       # glm4-9b prefill
        (1, 8, 1, 512, 512, 256, bf16, True, None, None),    # gemma-2b heads
        (1, 8, 2, 1000, 1000, 128, f32, True, 256, None),    # sliding window
        (1, 8, 2, 1000, 1000, 128, bf16, True, 256, None),
        (2, 4, 2, 300, 512, 64, f32, False, None, 450),      # kv_len padding
        (2, 4, 2, 300, 512, 64, bf16, False, None, 450))]
    # the SSD scan at the mamba2-130m prefill: B 8, S 2048, H 24, P 64,
    # N 128, chunk 256; from a zero state and continuing a cache; and at
    # jamba-1.5-large's: H 256 (d_inner 16,384 / headdim 64)
    cases += [ssd_case(randn, LM_BATCH, LM_PROMPT, 24, 64, 128, 256, s0)
              for s0 in (False, True)]
    cases.append(ssd_case(randn, LM_BATCH, LM_PROMPT, 256, 64, 128, 256,
                          False))
    return cases


def graph_stores(dense_ops, edge_ops, dense_nodes: int, edge_nodes: int,
                 e_cap: int, seed: int):
    """Device stores built from the sessions' op streams, and the
    sessions' query mixes: what ``kernel_cases`` takes."""
    from repro_torch.core.store import TemporalGraphStore
    stores = []
    for ops, n, layout, cap in ((dense_ops, dense_nodes, "dense", None),
                                (edge_ops, edge_nodes, "edge", e_cap)):
        st = TemporalGraphStore(n, e_cap=cap, layout=layout, device="cuda")
        st.ingest([(o.op, o.u, o.v, o.t) for o in ops])
        st.advance_to(ops[-1].t)
        stores.append(st)
    return (*stores, query_mix(dense_ops[-1].t, dense_nodes, True, seed),
            query_mix(edge_ops[-1].t, edge_nodes, False, seed))


def first_call(seed: int) -> int:
    """A new kernel's first call on the card: build with ptxas's report
    of registers, shared memory and spills per kernel instance, hold
    every graph-kernel case at a small size (dense 2048 nodes, edge
    8192: ragged tiles, per-query anchors, row_mask, several sweeps,
    global nets) and small cases of flash attention (bf16, every head
    dim and mask) and the SSD scan (ragged chunk, nonzero state) against
    their plain versions, untimed but for the LM cases, and stop."""
    import torch

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load(verbose=True)      # the wrappers' ext() then finds it built
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    cases = kernel_cases(*graph_stores(make_ops(2048, seed),
                                       make_ops(8192, seed), 2048, 8192,
                                       1 << 17, seed), seed)
    for c in cases:
        c["timed"] = False
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    bf16 = torch.bfloat16
    cases += [attention_case(randn, *args) for args in (
        (1, 3, 1, 300, 300, 64, bf16, True, None, None),
        (2, 4, 2, 200, 200, 128, bf16, True, 96, None),
        (1, 2, 1, 130, 130, 256, bf16, True, None, None),
        (1, 4, 2, 200, 200, 112, bf16, True, None, None),
        (1, 2, 1, 100, 256, 64, bf16, False, None, 150))]
    cases += [ssd_case(randn, 2, 512, 4, 64, 128, 256, False),
              ssd_case(randn, 2, 300, 3, 64, 128, 100, True)]
    bad = 0
    for c in cases:
        try:
            phase_kernels([c])
        except AssertionError as exc:
            bad += 1
            log(f"chip_smoke: {exc}")
    return fail(f"{bad} first-call cases disagree") if bad else 0


# ---------------------------------------------------------------------------
# Phases 3 and 4: the sessions
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    """Wait for every visible card (a mesh may span several)."""
    import torch
    if torch.device(device).type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def run_session(ops, n_cap: int, layout: str, device: str, qmix, sw,
                e_cap=None, sample_only: bool = False, **session_kw):
    """Ingest in flushed batches, then the mixed batch, sweeps and a
    snapshot (``session_kw``: ``mesh``; ``path`` for a durable session,
    ``indexed``).  Returns a dict: answers, sweeps, snapshot, stats,
    session, seconds per step, and the executor groups of the mixed
    batch."""
    from repro_torch.api import GraphSession
    from repro_torch.core.plans import Query
    steps = {}

    def step(name, t0):
        _sync(device)
        steps[name] = steps.get(name, 0.0) + time.perf_counter() - t0

    s = GraphSession(n_cap=n_cap, e_cap=e_cap, layout=layout, device=device,
                     slow_query_ms=None, **session_kw)
    for b in batches(ops, 4):
        t0 = time.perf_counter()
        s.ingest(b)
        step("ingest_s", t0)
        t0 = time.perf_counter()
        s.flush()
        step("flush_s", t0)
    qs = [Query(**q) for q, in_sample in qmix if in_sample or not sample_only]
    t0 = time.perf_counter()
    answers = s.query_many(qs)
    step("query_many_s", t0)
    groups = list(s.live.engine.last_group_stats)
    t0 = time.perf_counter()
    sweep_out = [s.sweep(**w) for w in sw]
    step("sweeps_s", t0)
    t0 = time.perf_counter()
    snap = s.snapshot_at(qmix[0][0]["t_k"])
    step("snapshot_s", t0)
    return dict(answers=answers, sweeps=sweep_out, snapshot=snap,
                stats=s.stats(), session=s, steps=steps, groups=groups)


def same(a, b) -> bool:
    """Equal bit for bit: dtype, shape and bits (floats compared as
    their integer bit patterns)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    return np.array_equal(a, b)


def differing(names, got, want) -> list:
    """The names of the answers that are not equal bit for bit (and
    "count" when the lists differ in length)."""
    bad = [n for n, a, b in zip(names, got, want) if not same(a, b)]
    return bad + (["count"] if len(got) != len(want) else [])


def _to_cpu(g):
    """A snapshot's tensors copied to the host (the same dataclass)."""
    import dataclasses

    import torch
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).cpu() for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})


def same_graph(a, b) -> bool:
    """Two snapshots (dense or edge-slot) equal bit for bit, wherever
    each lives."""
    import dataclasses

    import torch
    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def sparse_triangles(adj) -> int:
    import numpy as np
    import scipy.sparse as sp
    a = sp.csr_matrix(adj.cpu().numpy().astype(np.int64))
    return int((a @ a).multiply(a).sum() // 6)


def phase_session(name: str, ops, n_cap: int, layout: str, seed: int,
                  expect: dict, e_cap=None) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import build
    t_cur = ops[-1].t
    qmix = query_mix(t_cur, n_cap, layout == "dense", seed)
    sw = sweeps(t_cur, qmix[0][0]["v"])
    build.reset_launches()
    t0 = time.perf_counter()
    run = run_session(ops, n_cap, layout, "cuda", qmix, sw, e_cap=e_cap)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    answers, sweep_out, snap, stats, s, steps = (
        run["answers"], run["sweeps"], run["snapshot"], run["stats"],
        run["session"], run["steps"])
    print(f"{name} session: {len(ops)} ops, t_cur {stats['t_cur']}, "
          f"{len(answers)} queries + {len(sw)} sweeps + snapshot in "
          f"{seconds:.2f} s ({', '.join(f'{k} {v:.3f}' for k, v in steps.items())})"
          f"; launches {launches}", flush=True)
    for k, want in expect.items():
        if want and launches[k] == 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
        if not want and launches[k] != 0:
            raise AssertionError(f"{name}: kernel {k} launched "
                                 f"{launches[k]} times on a path that "
                                 "must not use it")
    for (q, _), a in zip(qmix, answers):
        arr = np.asarray(a)
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            raise AssertionError(f"{name}: non-finite answer for {q}")
        if q["measure"] == "degree_distribution" and arr.shape != (65,):
            raise AssertionError(f"{name}: histogram shape {arr.shape}")
    for q, a in zip([q for q, _ in qmix], answers):
        if q["measure"] == "triangles":
            g = s.snapshot_at(q["t_k"])
            want = sparse_triangles(g.adj)
            if int(a) != want:
                raise AssertionError(f"{name}: triangles {int(a)} != "
                                     f"sparse count {want} at {q}")
    # the same session on the CPU, sampled answers only
    t1 = time.perf_counter()
    cpu_run = run_session(ops, n_cap, layout, "cpu", qmix, sw, e_cap=e_cap,
                          sample_only=True)
    c_ans, c_sw, c_snap, c_stats = (cpu_run["answers"], cpu_run["sweeps"],
                                    cpu_run["snapshot"], cpu_run["stats"])
    del cpu_run
    cpu_seconds = time.perf_counter() - t1
    gpu_sample = [a for (q, keep), a in zip(qmix, answers) if keep]
    n_cmp = len(gpu_sample) + len(sw) + 2
    bad = [q for (q, _), x, y in zip([m for m in qmix if m[1]], gpu_sample,
                                      c_ans) if not same(x, y)]
    bad += [w for w, x, y in zip(sw, sweep_out, c_sw) if not same(x, y)]
    if not same(snap.nodes.cpu(), c_snap.nodes):
        bad.append("snapshot nodes")
    served = {k: v for k, v in stats.items() if not k.startswith("cache_")}
    if served != {k: c_stats[k] for k in served}:
        bad.append(("stats", stats, c_stats))
    if bad:
        raise AssertionError(f"{name}: GPU and CPU answers differ: {bad}")
    print(f"{name} session: {n_cmp} sampled answers equal the CPU port "
          f"bit for bit (CPU side {cpu_seconds:.2f} s)", flush=True)
    # what phases 7-10 are held to, kept on the host (and the store,
    # which phase 10 places on its mesh)
    memory = dict(answers=answers, sweeps=sweep_out,
                  snapshot=_to_cpu(snap), current=_to_cpu(s.store.current),
                  store=s.store)
    return dict(seconds=seconds, cpu_seconds=cpu_seconds, steps=steps,
                launches=launches, n_ops=len(ops), t_cur=stats["t_cur"],
                queries=len(answers), compared=n_cmp, stats=stats), memory


# ---------------------------------------------------------------------------
# Phases 7 and 8: durable, indexed sessions; one crash on the card
# ---------------------------------------------------------------------------

# phase 8's child dies right after the drain record of this swap
CRASH_AT_DRAIN = 2
CHILD_TIMEOUT_S = 600


def root_bytes(root: str) -> dict:
    """What a durable root holds on disk: bytes and files of its
    manifest, WAL and sealed segments, and the total."""
    files = {}
    for d, _, names in os.walk(root):
        for f in names:
            path = os.path.join(d, f)
            files[os.path.relpath(path, root)] = os.path.getsize(path)
    wal = [k for k in files if k.startswith("wal_")]
    seg = [k for k in files if k.startswith("segments" + os.sep)]
    return dict(manifest=files.get("MANIFEST.json", 0),
                wal=sum(files[k] for k in wal), wal_files=len(wal),
                segments=sum(files[k] for k in seg), segment_files=len(seg),
                total=sum(files.values()))


# the trace spans of ``open_store`` on an existing root, by the step of
# the reopen's split each one times
RECOVERY_SPANS = {"recovery": "recovery_s",
                  "recovery.segments": "segments_s",
                  "recovery.tree": "tree_s",
                  "recovery.wal_read": "wal_read_s",
                  "recovery.host_rebuild": "host_rebuild_s",
                  "recovery.card_rebuild": "card_rebuild_s",
                  "recovery.replay": "replay_s"}


def recovery_split(events: list[dict], open_s: float) -> dict:
    """The reopen's host seconds by step, from the spans of one
    ``GraphSession.open`` and its total ``open_s``: manifest and
    segment load (``load_s``: what recovery spent outside the host
    rebuild, card rebuild and replay; of it ``segments_s`` for mapping
    and CRC-checking the segment files, ``tree_s`` for rebuilding the
    merged-delta tree over them, ``wal_read_s`` for reading the WAL),
    host rebuild (mirror and slot registry), card rebuild (the log onto
    the card, ``current`` and anchors by LWW reconstruction from the
    empty graph; recovery synchronizes the card at its end), WAL
    replay, and the serving state (``serve_s``: the frozen engine and
    the node-centric index)."""
    steps = dict.fromkeys(RECOVERY_SPANS.values(), 0.0)
    for e in events:
        if e["name"] in RECOVERY_SPANS:
            steps[RECOVERY_SPANS[e["name"]]] += e["dur"] / 1e6
    rec = steps.pop("recovery_s")
    steps["load_s"] = rec - sum(steps[k] for k in (
        "host_rebuild_s", "card_rebuild_s", "replay_s"))
    steps["serve_s"] = open_s - rec
    steps["open_s"] = open_s
    return steps


def traced(fn, device):
    """``fn()`` under a ``Tracer`` installed for the call (the one
    installed before, if any, is put back after): its result, the
    recorded trace events and its host seconds, the card synchronized
    before and after."""
    from repro_torch.obs.trace import (Tracer, active_tracer,
                                       install_tracer, uninstall_tracer)
    before, tracer = active_tracer(), install_tracer(Tracer())
    try:
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        seconds = time.perf_counter() - t0
    finally:
        uninstall_tracer(tracer)
        if before is not None:
            install_tracer(before)
    return out, tracer.events(), seconds


def reopen(root: str, device, steps: dict):
    """``GraphSession.open(root, indexed=True)`` — crash recovery on
    ``device`` — with its host time split by ``recovery_split`` from a
    tracer installed for the call."""
    from repro_torch import api
    s, events, open_s = traced(lambda: api.GraphSession.open(
        root, device=device, indexed=True, slow_query_ms=None), device)
    steps.update(recovery_split(events, open_s))
    return s


def held_to(name: str, memory: dict, qmix, answers, sweep_out, snap,
            current=None) -> list:
    """What of a durable run differs from the in-memory session's
    (``memory``, from phase 3 or 4): answers, sweeps, snapshot and,
    given, ``current`` — every one bit for bit."""
    bad = differing([q for q, _ in qmix], answers, memory["answers"])
    bad += differing(list(range(len(sweep_out))), sweep_out,
                     memory["sweeps"])
    if not same_graph(_to_cpu(snap), memory["snapshot"]):
        bad.append("snapshot")
    if current is not None and not same_graph(_to_cpu(current),
                                              memory["current"]):
        bad.append("current")
    return [f"{name}: {b}" for b in bad]


# phase 7's indexed-against-unindexed groups: node queries of each
# measure-only plan, at a group size a loaded server batches
INDEXED_AB_QUERIES = 512


def node_queries(engine, n: int, seed: int) -> dict:
    """``n`` node-degree queries of each measure-only plan (hybrid
    points, delta-only diffs) over nodes with 1 to ``node_cap`` ops —
    the nodes the planner would send through the node-centric index."""
    import numpy as np
    from repro_torch.core.plans import Query
    counts = np.diff(engine.index.row_ptr.cpu().numpy())
    nodes = np.flatnonzero((counts >= 1) & (counts <= engine.node_cap))
    rng = np.random.default_rng(seed)
    vs = rng.choice(nodes, size=2 * n)
    ts = rng.integers(1, engine.t_cur + 1, size=(2 * n, 2))
    lo, hi = ts.min(1), ts.max(1)
    return {"hybrid": [Query(kind="point", scope="node", measure="degree",
                             t_k=int(t), v=int(v))
                       for t, v in zip(lo[:n], vs[:n])],
            "delta_only": [Query(kind="diff", scope="node",
                                 measure="degree", t_k=int(a), t_l=int(b),
                                 v=int(v))
                           for a, b, v in zip(lo[n:], hi[n:], vs[n:])]}


def indexed_ab(engine, device, seed: int, reps: int = 5) -> dict:
    """Each plan's group of ``INDEXED_AB_QUERIES`` node queries forced
    indexed and unindexed, in turn: the host ms of one
    ``evaluate_many`` (the card synchronized; the median of ``reps``
    after one untimed call each), the answers equal bit for bit, and
    each indexed call one indexed group."""
    import statistics
    out, bad = {}, []
    for plan, qs in node_queries(engine, INDEXED_AB_QUERIES, seed).items():
        ms, answers = {True: [], False: []}, {}
        for rep in range(reps + 1):
            for ix in (True, False):
                _sync(device)
                t0 = time.perf_counter()
                answers[ix] = engine.evaluate_many(qs, plan=plan,
                                                   indexed=ix)
                _sync(device)
                if rep:
                    ms[ix].append(1e3 * (time.perf_counter() - t0))
                if ix and [k.indexed for k, *_ in
                           engine.last_group_stats] != [True]:
                    bad.append(f"{plan}: the forced group ran unindexed")
        bad += [f"{plan} indexed: query {i}" for i in differing(
            range(len(qs)), answers[True], answers[False])]
        out[plan] = dict(queries=len(qs),
                         indexed_ms=statistics.median(ms[True]),
                         unindexed_ms=statistics.median(ms[False]))
    if bad:
        raise AssertionError("; ".join(sorted(set(bad))))
    return out


def phase_durable(name: str, ops, n_cap: int, layout: str, seed: int,
                  memory: dict, expect: dict, recovery_kernel: str,
                  root: str, e_cap=None, device="cuda") -> dict:
    """Phase 7 on one layout: the session of phase 3 / 4, durable at
    ``root`` and indexed, then closed and reopened (recovery on
    ``device``), the same mix answered before the close and after the
    reopen, both held bit for bit to the in-memory session's answers,
    ``current`` to its ``current``; the reopen must launch
    ``recovery_kernel`` and indexed groups must run."""
    from repro_torch.core.plans import Query
    from repro_torch.kernels import build
    t_cur = ops[-1].t
    qmix = query_mix(t_cur, n_cap, layout == "dense", seed)
    sw = sweeps(t_cur, qmix[0][0]["v"])
    build.reset_launches()
    run = run_session(ops, n_cap, layout, device, qmix, sw, e_cap=e_cap,
                      path=root, indexed=True)
    s, steps = run["session"], run["steps"]
    indexed = sum(b for k, b, _ in run["groups"] if k.indexed)
    bad = held_to(f"{name} durable", memory, qmix, run["answers"],
                  run["sweeps"], run["snapshot"], s.store.current)
    t0 = time.perf_counter()
    s.close()
    steps["close_s"] = time.perf_counter() - t0
    del run, s
    durable_launches = dict(build.LAUNCHES)
    disk = root_bytes(root)

    build.reset_launches()
    s = reopen(root, device, steps)
    open_launches = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    answers = s.query_many([Query(**q) for q, _ in qmix])
    _sync(device)
    steps["first_query_s"] = time.perf_counter() - t0
    indexed_reopen = sum(b for k, b, _ in s.live.engine.last_group_stats
                         if k.indexed)
    sweep_out = [s.sweep(**w) for w in sw]
    snap = s.snapshot_at(qmix[0][0]["t_k"])
    _sync(device)
    reopen_launches = dict(build.LAUNCHES)
    bad += held_to(f"{name} reopened", memory, qmix, answers, sweep_out,
                   snap, s.store.current)
    ab = indexed_ab(s.live.engine, device, seed)
    s.close()
    del s
    print(f"{name} durable session: {len(ops)} ops, root {disk['total']} "
          f"bytes (manifest {disk['manifest']}, WAL {disk['wal']} in "
          f"{disk['wal_files']} file, segments {disk['segments']} in "
          f"{disk['segment_files']} files); "
          + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
          + f"; indexed queries {indexed} (after the reopen "
          f"{indexed_reopen}); launches durable {durable_launches}, "
          f"reopen {open_launches}, reopen + mix {reopen_launches}; "
          "groups of node queries, ms indexed / unindexed: "
          + ", ".join(f"{p} x{r['queries']} {r['indexed_ms']:.3f} / "
                      f"{r['unindexed_ms']:.3f}" for p, r in ab.items()),
          flush=True)
    for k, want in expect.items():
        if want and durable_launches[k] == 0:
            bad.append(f"{name} durable: kernel {k} never launched")
        for run_name, got in (("durable", durable_launches),
                              ("reopen", reopen_launches)):
            if not want and got[k] != 0:
                bad.append(f"{name} {run_name}: kernel {k} launched "
                           f"{got[k]} times on a path that must not use it")
    if open_launches[recovery_kernel] == 0:
        bad.append(f"{name}: the reopen did not launch {recovery_kernel}")
    if not (indexed and indexed_reopen):
        bad.append(f"{name}: no query ran through the node-centric index")
    if bad:
        raise AssertionError("; ".join(map(str, bad)))
    print(f"{name} durable session: {len(qmix)} answers, {len(sw)} sweeps, "
          "a snapshot and current equal the in-memory session's bit for "
          "bit, before the close and after the reopen", flush=True)
    return dict(steps=steps, root_bytes=disk, indexed_queries=indexed,
                indexed_queries_reopened=indexed_reopen, indexed_ab=ab,
                launches=durable_launches, reopen_launches=reopen_launches,
                open_launches=open_launches)


def read_acks(path: str) -> tuple[list[int], list[int]]:
    """The crash child's acknowledgements: the last time of every
    acknowledged batch and every watermark it served."""
    batch_ts, swap_ws = [], []
    with open(path) as fh:
        for line in fh:
            kind, value = line.split()
            (batch_ts if kind == "batch" else swap_ws).append(int(value))
    return batch_ts, swap_ws


def crash_child(root: str, n_nodes: int, seed: int, device="cuda") -> int:
    """Phase 8's child: the dense configuration durably on ``device``,
    one flushed batch after another, acknowledging each batch and each
    served watermark in ``root/acks.log``; it SIGKILLs itself right
    after the drain record of swap ``CRASH_AT_DRAIN`` is in the WAL.
    Returns 3 if it lived to the end."""
    import signal

    from repro_torch.api import GraphSession
    s = GraphSession(path=root, n_cap=n_nodes, layout="dense",
                     device=device, indexed=True, slow_query_ms=None)
    persist = s.store.persist
    log_drain, drains = persist.log_drain, [0]

    def drain_then_die(*args, **kw):
        log_drain(*args, **kw)
        drains[0] += 1
        if drains[0] == CRASH_AT_DRAIN:
            os.kill(os.getpid(), signal.SIGKILL)

    persist.log_drain = drain_then_die
    with open(os.path.join(root, "acks.log"), "a") as acks:
        def ack(line: str) -> None:
            acks.write(line + "\n")
            acks.flush()
            os.fsync(acks.fileno())

        for b in batches(make_ops(n_nodes, seed), 4):
            s.ingest(b)
            ack(f"batch {b[-1][3]}")
            s.flush()
            ack(f"swap {s.watermark}")
    return 3


def uncounted(fn):
    """``fn()`` with the launch counters left as they were: the
    from-scratch session phase 8 compares with is not the path it
    reads."""
    from repro_torch.kernels import build
    saved = dict(build.LAUNCHES)
    try:
        return fn()
    finally:
        build.LAUNCHES.update(saved)


def log_prefix_equal(store, oracle_store, t: int) -> bool:
    """``store``'s whole log (sealed segments and tail) is, op for op,
    the oracle's log up to time ``t``."""
    import numpy as np
    keep = int(np.searchsorted(oracle_store._t, t, side="right"))
    return all(np.array_equal(getattr(store, c),
                              getattr(oracle_store, c)[:keep])
               for c in ("_op", "_u", "_v", "_slot", "_t"))


def phase_crash(ops, n_cap: int, seed: int, root: str, device="cuda",
                child_cmd=None) -> dict:
    """Phase 8: a child process (``child_cmd``; default this script's
    ``--crash-child``) runs the dense configuration durably and dies
    mid-swap; reopened on ``device``, the store must hold every
    acknowledged batch, its log must be the from-scratch session's up to
    the watermark, and every query of the mix at t ≤ the recovered
    watermark, ``current`` and a snapshot must bit-match a from-scratch
    in-memory session over the same ops — before and after a flush."""
    import signal

    from repro_torch.api import GraphSession
    from repro_torch.core.plans import Query
    from repro_torch.kernels import build
    cmd = child_cmd or [sys.executable, os.path.abspath(__file__),
                        "--crash-child", root, "--dense-nodes", str(n_cap),
                        "--seed", str(seed)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"crash child exited {proc.returncode}, not "
                             f"by SIGKILL: {proc.stderr[-2000:]}")
    batch_ts, swap_ws = read_acks(os.path.join(root, "acks.log"))
    oracle = GraphSession(n_cap=n_cap, layout="dense", device=device,
                          slow_query_ms=None)
    for b in batches(ops, 4):
        oracle.ingest(b)
        oracle.flush()
    steps = {}
    build.reset_launches()
    s = reopen(root, device, steps)
    open_launches = dict(build.LAUNCHES)
    bad, checked = [], 0
    for when in ("before flush", "after flush"):
        if when == "after flush":
            s.flush()
        w = s.watermark
        if w < max(swap_ws, default=0):
            bad.append(f"{when}: watermark {w} behind a served "
                       f"{max(swap_ws)}")
        if when == "after flush" and w < max(batch_ts, default=0):
            bad.append(f"{when}: watermark {w} misses an acknowledged "
                       f"batch up to t={max(batch_ts)}")
        if not log_prefix_equal(s.store, oracle.store, w):
            bad.append(f"{when}: the log is not the oracle's up to t={w}")
        qmix = query_mix(w, n_cap, True, seed)
        qs = [Query(**q) for q, _ in qmix]
        t_snap = qmix[0][0]["t_k"]
        want = uncounted(lambda: (oracle.query_many(qs),
                                  oracle.snapshot_at(w),
                                  oracle.snapshot_at(t_snap)))
        bad += [f"{when}: {q}" for q in differing(
            [q for q, _ in qmix], s.query_many(qs), want[0])]
        if not same_graph(s.store.current, want[1]):
            bad.append(f"{when}: current differs from SG_{w}")
        if not same_graph(s.snapshot_at(t_snap), want[2]):
            bad.append(f"{when}: snapshot at {t_snap} differs")
        checked += len(qs) + 2
    _sync(device)
    launches = dict(build.LAUNCHES)
    s.close()
    print(f"crash: the child died by SIGKILL after the drain record of "
          f"swap {CRASH_AT_DRAIN} ({child_s:.1f} s, {len(batch_ts)} "
          f"batches and {len(swap_ws)} swaps acknowledged); reopened at "
          f"watermark {w} "
          + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
          + f"; {checked} answers checked; launches reopen "
          f"{open_launches}, reopen + checks {launches}", flush=True)
    if open_launches["delta_apply"] == 0:
        bad.append("the reopen did not launch delta_apply")
    if bad:
        raise AssertionError("crash: " + "; ".join(map(str, bad)))
    return dict(child_s=child_s, acked_batches=batch_ts, acked_swaps=swap_ws,
                watermark=w, steps=steps, checked=checked,
                open_launches=open_launches, launches=launches)


# ---------------------------------------------------------------------------
# Phase 9: replication — a durable writer publishing, read replicas on
# the card, a watermark-aware router
# ---------------------------------------------------------------------------

# the dense anchor-budget replica may hold this many snapshots of its own
REPLICA_ANCHORS = 4


class CountingTransport:
    """A transport that counts its fetches (the restarted replica must
    serve before it makes one)."""

    def __init__(self, inner):
        self.inner, self.fetches = inner, 0

    def fetch(self, relpath: str, *, timeout=None) -> bytes:
        self.fetches += 1
        return self.inner.fetch(relpath, timeout=timeout)


class Stoppable:
    """A router target that can be stopped, as a replica whose host went
    away: once stopped, its heartbeat and its queries fail."""

    def __init__(self, target):
        self.target, self.stopped = target, False

    def _alive(self) -> None:
        if self.stopped:
            raise ConnectionError("replica stopped")

    @property
    def watermark(self) -> int:
        return self.target.watermark

    def status(self) -> dict:
        self._alive()
        return self.target.status()

    def evaluate_many(self, queries, plan="auto", **kw):
        self._alive()
        return self.target.evaluate_many(queries, plan, **kw)


def served(answers) -> list:
    """Answers boxed as a session's frontend returns them (a 0-d result
    as its Python scalar), so they compare with a session's bit for
    bit."""
    import numpy as np
    out = []
    for a in answers:
        a = np.asarray(a)
        out.append(a.item() if a.ndim == 0 else a)
    return out


def launches_since(before: dict) -> dict:
    """Launches of each kernel since the counters read ``before`` (the
    kernels launched at least once)."""
    from repro_torch.kernels import build
    return {k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()
            if n > before.get(k, 0)}


def replica_child(publish_root: str, local_root: str, device="cuda") -> int:
    """Phase 9's child: reopen the replica mirror at ``local_root`` (on
    ``device``) and sync it from ``publish_root``; it SIGKILLs itself
    inside that sync, after the new segment files and WAL reach the
    mirror and before the mirror's manifest rename.  Returns 3 if it
    lived to the end."""
    import signal

    from repro_torch.persist import manifest as mf
    from repro_torch.replica import LocalDirTransport, ReadReplica
    write_manifest = mf.write_manifest

    def die_before_rename(root, manifest):
        if os.path.abspath(root) == os.path.abspath(local_root):
            os.kill(os.getpid(), signal.SIGKILL)
        return write_manifest(root, manifest)

    mf.write_manifest = die_before_rename
    replica = ReadReplica(LocalDirTransport(publish_root), local_root,
                          name="child", device=device)
    replica.sync()
    return 3


def _replica_kill(pub: str, mirror: str, w_old: int, memory: dict, qmix,
                  device, child_cmd) -> dict:
    """The kill -9 of phase 9: a child reopens ``mirror`` (a replica's
    mirror at watermark ``w_old``) and dies mid-sync; the mirror is then
    reopened here before any fetch, must serve ``w_old`` (the mix's
    queries at t ≤ ``w_old``), and rejoins by diff."""
    import signal

    from repro_torch.core.plans import Query
    from repro_torch.kernels import build
    from repro_torch.persist import manifest as mf
    from repro_torch.replica import LocalDirTransport, ReadReplica
    t0 = time.perf_counter()
    proc = subprocess.run(child_cmd(pub, mirror), capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)
    out = dict(child_s=time.perf_counter() - t0, child_rc=proc.returncode,
               w_old=w_old, bad=[])
    if proc.returncode != -signal.SIGKILL:
        out["bad"].append(f"replica child exited {proc.returncode}, not by "
                          f"SIGKILL: {proc.stderr[-2000:]}")
        return out
    named = {e["file"] for e in mf.read_manifest(mirror)["segments"]}
    on_disk = {os.path.join(mf.SEGMENT_DIR, f)
               for f in os.listdir(os.path.join(mirror, mf.SEGMENT_DIR))}
    out["segments_beyond_manifest"] = len(on_disk - named)
    guard = CountingTransport(LocalDirTransport(pub))
    before = dict(build.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    rep = ReadReplica(guard, mirror, name="restarted", device=device)
    _sync(device)
    out["restart_s"] = time.perf_counter() - t0
    out["restart_launches"] = launches_since(before)
    out["fetches_before_serving"] = guard.fetches
    out["watermark_restart"] = rep.watermark
    old = [(q, a) for (q, _), a in zip(qmix, memory["answers"])
           if max(q["t_k"], q.get("t_l") or 0) <= w_old]
    out["old_queries"] = len(old)
    got = served(rep.evaluate_many([Query(**q) for q, _ in old]))
    out["bad"] += [f"restart at {w_old}: {q}" for q in differing(
        [q for q, _ in old], got, [a for _, a in old])]
    t0 = time.perf_counter()
    rec = rep.sync()
    _sync(device)
    out["rejoin_s"] = time.perf_counter() - t0
    out["rejoin_mode"] = rec["mode"]
    out["stats"] = rep.stats.asdict()
    out["watermark"] = rep.watermark
    got = served(rep.evaluate_many([Query(**q) for q, _ in qmix]))
    out["bad"] += [f"rejoined: {q}" for q in differing(
        [q for q, _ in qmix], got, memory["answers"])]
    if not same_graph(_to_cpu(rep.store.current), memory["current"]):
        out["bad"].append("rejoined: current")
    return out


def serve_while_syncing(rep, qmix, memory: dict, target: int, out: dict,
                        timeout: float = CHILD_TIMEOUT_S) -> None:
    """Start ``rep``'s poll thread and, until it reaches watermark
    ``target``, answer the queries of the mix it covers, again and
    again; then stop the thread.  History at or below a watermark is
    immutable, so each answer must equal the in-memory session's
    whichever engine served it.  Counts the answers checked and the
    watermarks seen into ``out``, and whether the thread ended."""
    from repro_torch.core.plans import Query
    rep.start(0.01)
    thread = rep._poll_thread
    deadline = time.monotonic() + timeout
    try:
        while True:
            w = rep.watermark
            cover = [(q, a) for (q, _), a in zip(qmix, memory["answers"])
                     if max(q["t_k"], q.get("t_l") or 0) <= w]
            if cover:
                got = served(rep.evaluate_many([Query(**q)
                                                for q, _ in cover]))
                out["bad"] += [f"at {w}: {q}" for q in differing(
                    [q for q, _ in cover], got, [a for _, a in cover])]
                out["checked"] += len(cover)
            out["watermarks"] = sorted(set(out["watermarks"]) | {w})
            if w >= target:
                break
            if time.monotonic() > deadline:
                out["bad"].append(f"never reached t={target} (at {w})")
                break
    finally:
        rep.stop()
    out["stopped"] = out.get("stopped", True) and not thread.is_alive()


def phase_replication(name: str, ops, n_cap: int, layout: str, seed: int,
                      memory: dict, work: str, e_cap=None, device="cuda",
                      child_cmd=None) -> dict:
    """Phase 9 on one layout: a durable writer publishes every swap
    (``publish_to`` before its first batch); replica A syncs after each
    flush; replica B opens after the last (readonly recovery on
    ``device``; on dense with an anchor budget); a router over both
    serves the mix of phase 3 / 4 twice (load spreads: A, then B), B's
    anchors follow its traffic (dense), A is stopped and the mix routed
    again (failover to B), and a batch past every watermark must raise.
    On dense also replica T, syncing on its poll thread while this
    thread serves the mix's covered queries from it after every flush, a
    replica behind a transport that flips a bit of the first segment
    fetch, and a kill -9 of a replica mid-sync
    (``child_cmd(publish_root, mirror)``; default this script's
    ``--replica-child``).  Returns what ``replication_failures`` reads;
    raises ``AssertionError`` naming every failed check."""
    import shutil

    import torch

    from repro_torch.api import GraphSession
    from repro_torch.core.engine import WatermarkError, _snapshot_bytes
    from repro_torch.core.plans import Query
    from repro_torch.kernels import build
    from repro_torch.persist import manifest as mf
    from repro_torch.replica import (FaultInjector, FaultyTransport,
                                     LocalDirTransport)
    dense = layout == "dense"
    child_cmd = child_cmd or (lambda pub, mirror: [
        sys.executable, os.path.abspath(__file__), "--replica-child", pub,
        mirror])
    W, P = os.path.join(work, "writer"), os.path.join(work, "publish")
    qmix = query_mix(ops[-1].t, n_cap, dense, seed)
    qs = [Query(**q) for q, _ in qmix]
    names = [q for q, _ in qmix]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = dict(bad=[], sync=[])

    build.reset_launches()
    s = GraphSession(path=W, n_cap=n_cap, e_cap=e_cap, layout=layout,
                     device=device, slow_query_ms=None)
    pub = s.publish_to(P)
    a = GraphSession.open_replica(P, os.path.join(work, "A"), device=device,
                                  name="A")
    res["sync"].append(dict(mode="initial",
                            seconds=a.stats.last_sync_seconds,
                            records=a.stats.records_applied))
    if dense:
        # replica T syncs on its own poll thread, run after each of A's
        # syncs, while this thread serves from it: new frozen engines
        # are built on the card while the old ones answer
        t_rep = GraphSession.open_replica(P, os.path.join(work, "T"),
                                          device=device, name="T")
        res["threaded"] = dict(checked=0, watermarks=[], bad=[])
    res["writer_s"] = []
    for i, b in enumerate(batches(ops, 4)):
        t0 = time.perf_counter()
        s.ingest(b)
        s.flush()
        _sync(device)
        res["writer_s"].append(time.perf_counter() - t0)
        rec = a.sync()
        _sync(device)
        res["sync"].append(dict(mode=rec["mode"], seconds=rec["seconds"],
                                records=rec["records_applied"]))
        if dense and i == 1:
            # the kill -9's mirror: A's, as it stands between syncs
            shutil.copytree(os.path.join(work, "A"),
                            os.path.join(work, "K"))
            w_old = a.watermark
        if dense:
            serve_while_syncing(t_rep, qmix, memory, s.watermark,
                                res["threaded"])
    if dense:
        th = res["threaded"]
        th.update(stats=t_rep.stats.asdict(), watermark=t_rep.watermark)
        th["bad"] += [f"stopped: {q}" for q in differing(
            names, served(t_rep.evaluate_many(qs)), memory["answers"])]
        if not same_graph(_to_cpu(t_rep.store.current), memory["current"]):
            th["bad"].append("stopped: current")
        del t_rep
    res["publish"] = [dict(epoch=r.epoch, segments=r.segments_shipped,
                           bytes=r.bytes_shipped, seconds=r.seconds)
                      for r in pub.history]
    res["writer_watermark"] = s.watermark
    res["a_watermark"] = a.watermark

    before = dict(build.LAUNCHES)
    budget = (REPLICA_ANCHORS * _snapshot_bytes(s.store.current)
              if dense else None)
    b, events, open_s = traced(lambda: GraphSession.open_replica(
        P, os.path.join(work, "B"), device=device, name="B",
        anchor_budget_bytes=budget), device)
    res["b_open"] = recovery_split(events, open_s)
    res["b_open_launches"] = launches_since(before)
    for rep in (a, b):
        if not same_graph(_to_cpu(rep.store.current), memory["current"]):
            res["bad"].append(f"replica {rep.name}: current")

    targets = {"A": Stoppable(a), "B": Stoppable(b)}
    router = GraphSession.open_router(targets)
    res["route_s"], res["routed_to"] = [], []
    for _ in range(2):
        served_before = {k: t.target.stats.queries_served
                         for k, t in targets.items()}
        _sync(device)
        t0 = time.perf_counter()
        got = router.evaluate_many(qs)
        _sync(device)
        res["route_s"].append(time.perf_counter() - t0)
        res["routed_to"] += [k for k, t in targets.items()
                             if t.target.stats.queries_served
                             > served_before[k]]
        res["bad"] += [f"routed: {q}" for q in differing(
            names, served(got), memory["answers"])]
    if dense:
        before = dict(build.LAUNCHES)
        b.refresh_anchors()
        _sync(device)
        res["anchor_launches"] = launches_since(before)
        res["anchors"] = list(b.store.materialized.times)

    targets["A"].stopped = True
    _sync(device)
    t0 = time.perf_counter()
    got = router.evaluate_many(qs)
    _sync(device)
    res["failover_s"] = time.perf_counter() - t0
    res["failovers"] = router.failovers
    res["bad"] += [f"failover: {q}" for q in differing(
        names, served(got), memory["answers"])]
    try:
        router.evaluate_many([Query("point", "global", "num_edges",
                                    t_k=b.watermark + 1)])
        res["watermark_error"] = False
    except WatermarkError:
        res["watermark_error"] = True
    res["launches"] = launches_since({})
    res["a_stats"], res["b_stats"] = a.stats.asdict(), b.stats.asdict()
    res["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    s.close()
    del s, a, b, router, targets

    if dense:
        inj = FaultInjector(seed=seed)
        inj.add(f"fetch:{mf.segment_name(0)}", "bit_flip", nth=1)
        c = GraphSession.open_replica(
            FaultyTransport(LocalDirTransport(P), inj),
            os.path.join(work, "C"), device=device, name="C",
            backoff_base=0.001)
        res["fault"] = dict(fired=list(inj.fired),
                            quarantined=c.stats.quarantined,
                            files=len(os.listdir(os.path.join(
                                work, "C", "quarantine"))))
        res["bad"] += [f"faulty transport: {q}" for q in differing(
            names, served(c.evaluate_many(qs)), memory["answers"])]
        if not same_graph(_to_cpu(c.store.current), memory["current"]):
            res["bad"].append("faulty transport: current")
        del c
        res["kill"] = _replica_kill(P, os.path.join(work, "K"), w_old,
                                    memory, qmix, device, child_cmd)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(replication_line(name, res), flush=True)
    bad = replication_failures(res, layout)
    if bad:
        raise AssertionError("; ".join(bad))
    print(f"{name} replication: {len(qs)} answers a route (A, B, then "
          "failover to B) and each replica's current equal the in-memory "
          "session's bit for bit", flush=True)
    return res


def replication_failures(res: dict, layout: str) -> list:
    """Phase 9's verdict on one layout's results (``phase_replication``):
    every failed check, named; empty when the phase passed."""
    name = f"{layout} replication"
    bad = [f"{name}: {b}" for b in res["bad"]]
    modes = [r["mode"] for r in res["sync"]]
    if not {"rotate", "incremental"} & set(modes):
        bad.append(f"{name}: replica A never caught up by diff ({modes})")
    if res["a_stats"]["full_rebuilds"]:
        bad.append(f"{name}: replica A fell back to "
                   f"{res['a_stats']['full_rebuilds']} full rebuilds")
    if res["a_watermark"] != res["writer_watermark"]:
        bad.append(f"{name}: replica A at {res['a_watermark']}, the writer "
                   f"at {res['writer_watermark']}")
    kernel = "delta_apply" if layout == "dense" else "edge_delta_apply"
    if res["b_open_launches"].get(kernel, 0) == 0:
        bad.append(f"{name}: replica B's open did not launch {kernel}")
    for k in ("edge_delta_apply", "degree_series") + (
            ("delta_apply",) if layout == "dense" else ()):
        if res["launches"].get(k, 0) == 0:
            bad.append(f"{name}: kernel {k} never launched")
    if layout == "edge" and res["launches"].get("delta_apply", 0):
        bad.append(f"{name}: kernel delta_apply launched "
                   f"{res['launches']['delta_apply']} times on a path that "
                   "must not use it")
    if "anchor_launches" in res and not res["anchor_launches"].get(
            "delta_apply", 0):
        bad.append(f"{name}: replica B's refresh_anchors did not launch "
                   "delta_apply")
    if sorted(res["routed_to"]) != ["A", "B"]:
        bad.append(f"{name}: the two routes went to {res['routed_to']}, "
                   "not A and B")
    if res["failovers"] != 1:
        bad.append(f"{name}: {res['failovers']} failovers, not 1")
    if not res["watermark_error"]:
        bad.append(f"{name}: a batch past every watermark was answered")
    th = res.get("threaded")
    if th is not None:
        bad += [f"{name}: threaded replica: {b}" for b in th["bad"]]
        if not th["stopped"]:
            bad.append(f"{name}: threaded replica: the poll thread did not "
                       "stop")
        if th["watermark"] != res["writer_watermark"] or th["stats"][
                "full_rebuilds"]:
            bad.append(f"{name}: threaded replica at {th['watermark']} "
                       f"after {th['stats']['full_rebuilds']} full rebuilds")
    if "fault" in res and (res["fault"]["quarantined"], res["fault"]["files"]
                           ) != (1, 1):
        bad.append(f"{name}: the bit flip quarantined "
                   f"{res['fault']['quarantined']} payloads, not 1")
    k = res.get("kill")
    if k is not None:
        bad += [f"{name}: kill -9: {b}" for b in k["bad"]]
    if k is not None and "stats" in k:
        if k["segments_beyond_manifest"] == 0:
            bad.append(f"{name}: the child died before a new segment file "
                       "reached its mirror")
        if (k["fetches_before_serving"], k["watermark_restart"]) != (
                0, k["w_old"]):
            bad.append(f"{name}: the restart served watermark "
                       f"{k['watermark_restart']} after "
                       f"{k['fetches_before_serving']} fetches (the mirror "
                       f"held {k['w_old']}, served before any fetch)")
        if k["stats"]["segments_reused"] == 0 or k["stats"]["full_rebuilds"]:
            bad.append(f"{name}: the restart did not rejoin by diff "
                       f"({k['stats']})")
        if k["watermark"] != res["writer_watermark"]:
            bad.append(f"{name}: the restart rejoined at {k['watermark']}")
        if not k["restart_launches"].get(kernel, 0):
            bad.append(f"{name}: the restart from the mirror did not "
                       f"launch {kernel}")
    return bad


def replication_line(name: str, res: dict) -> str:
    """Phase 9's printed line: the writer's seconds a batch (ingest and
    flush, the publish included), publish seconds and bytes a swap, sync
    seconds by mode, bytes fetched, replica B's open split, routed and
    failover seconds, peak device memory."""
    by_mode: dict = {}
    for r in res["sync"]:
        by_mode.setdefault(r["mode"], []).append(r["seconds"])
    line = (f"{name} replication: writer ingest + flush s a batch "
            + " ".join(f"{x:.3f}" for x in res["writer_s"])
            + "; publish s/bytes a swap "
            + ", ".join(f"{p['seconds']:.3f}/{p['bytes']}"
                        for p in res["publish"])
            + "; A syncs " + ", ".join(
                f"{m} {' '.join(f'{x:.3f}' for x in v)} s"
                for m, v in by_mode.items())
            + f", fetched {res['a_stats']['bytes_fetched']} bytes; B open "
            + ", ".join(f"{k} {v:.3f}" for k, v in res["b_open"].items())
            + f", fetched {res['b_stats']['bytes_fetched']} bytes, launches "
            f"{res['b_open_launches']}; routed query_many "
            + " / ".join(f"{x:.3f}" for x in res["route_s"])
            + f" s to {res['routed_to']}, failover {res['failover_s']:.3f} s"
            + (f"; anchors {res['anchors']} (launches "
               f"{res['anchor_launches']})" if "anchors" in res else "")
            + f"; launches {res['launches']}; peak device memory "
            + (f"{res['peak_bytes'] / 2**30:.2f} GiB"
               if res["peak_bytes"] is not None else "not measured"))
    th = res.get("threaded")
    if th is not None:
        line += (f"; threaded replica T: {th['checked']} answers checked "
                 f"while it synced, watermarks {th['watermarks']}, "
                 f"{th['stats']['syncs']} syncs")
    if "fault" in res:
        line += (f"; bit flip {res['fault']['fired']} quarantined "
                 f"{res['fault']['quarantined']}")
    k = res.get("kill")
    if k and "stats" in k:
        line += (f"; kill -9 child {k['child_s']:.1f} s, restart at "
                 f"{k['watermark_restart']} in {k['restart_s']:.3f} s "
                 f"({k['fetches_before_serving']} fetches, launches "
                 f"{k['restart_launches']}, {k['old_queries']} old "
                 "queries), rejoin "
                 f"{k['rejoin_mode']} {k['rejoin_s']:.3f} s, segments "
                 f"reused {k['stats']['segments_reused']} fetched "
                 f"{k['stats']['segments_fetched']}")
    return line


# ---------------------------------------------------------------------------
# Phase 10: multi-device serving on a mesh that names the card four times
# ---------------------------------------------------------------------------

# phase 10's mesh: the one card, four times (four shards of their own)
SHARDS = 4


def group_modes(stats) -> list:
    """The shard modes of an engine's ``last_group_stats``, one a group."""
    return [mode for _, _, mode in stats]


def phase_sharded(name: str, ops, n_cap: int, layout: str, seed: int,
                  memory: dict, store=None, device="cuda") -> dict:
    """Phase 10 on one layout, on a mesh of ``SHARDS`` shards: the
    visible cards in turn (``device`` repeated on one card or the CPU).

    Dense: a ``GraphSession(mesh=)`` ingests the ops of phase 3 in the
    same four flushed batches and serves the mix (auto), the sweeps and
    a snapshot; edge: phase 4's ``store`` is placed on the mesh
    (``place_on_mesh``) and serves the mix (auto).  Then, on both, the
    mix with ``shard="force"`` (on dense also with every layout pinned
    dense: the row blocks) and with ``shard="never"``: every answer
    (and on dense every sweep, forced too, and the snapshot) must equal
    the in-memory session's (``memory``) bit for bit.  On dense also
    ``dist_reconstruct``, ``dist_triangles`` and
    ``dist_batch_point_degree`` against their single-device values.
    The launch counters are zeroed before the session / placement and
    read after the mix.  Returns what ``sharded_failures`` reads;
    raises ``AssertionError`` naming every failed check."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import queries as TQ
    from repro_torch.core.plans import Query
    from repro_torch.kernels import build
    from repro_torch.sharding import graph_mesh, shard_rows
    dense = layout == "dense"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n_cards = torch.cuda.device_count() if cuda else 1
    mesh = graph_mesh([torch.device("cuda", i % n_cards) if n_cards > 1
                       else dev for i in range(SHARDS)])
    t_cur = ops[-1].t
    qmix = query_mix(t_cur, n_cap, dense, seed)
    sw = sweeps(t_cur, qmix[0][0]["v"])
    qs = [Query(**q) for q, _ in qmix]
    names = [str(q) for q, _ in qmix]
    res = dict(bad=[], steps={}, modes={}, mesh=[str(d) for d in
                                                 mesh.devices])
    steps = res["steps"]

    def timed(step, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        steps[step] = time.perf_counter() - t0
        return out

    def check(what, got, want):
        res["bad"] += [f"{what}: {q}" for q in differing(names, got, want)]

    cards = sorted({d.index for d in mesh.devices}) if cuda else []
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    build.reset_launches()
    if dense:
        run = run_session(ops, n_cap, layout, device, qmix, sw, mesh=mesh)
        steps.update(run["steps"])
        store, engine = run["session"].store, run["session"].live.engine
        res["modes"]["auto"] = group_modes(run["groups"])
        check("auto", run["answers"], memory["answers"])
        res["bad"] += [f"sweep {w}" for w, x, y in zip(
            sw, run["sweeps"], memory["sweeps"]) if not same(x, y)]
        if not same_graph(_to_cpu(run["snapshot"]), memory["snapshot"]):
            res["bad"].append("snapshot")
    else:
        engine = timed("place_on_mesh_s", lambda: store.place_on_mesh(mesh))
        check("auto", timed("query_many_s", lambda: served(
            engine.evaluate_many(qs))), memory["answers"])
        res["modes"]["auto"] = group_modes(engine.last_group_stats)
    # forced: the planner's layouts (global counts go to the slot
    # layout), and on dense every layout pinned dense (the row blocks)
    res["groups"] = {}
    for run_name, kw in (("force", {}),) + (
            (("force_dense", dict(layout="dense")),) if dense else ()):
        check(run_name, timed(f"{run_name}_s", lambda: served(
            engine.evaluate_many(qs, shard="force", **kw))),
            memory["answers"])
        res["modes"][run_name] = group_modes(engine.last_group_stats)
        res["groups"][run_name] = [
            dict(plan=k.plan, kind=k.kind, measure=k.measure,
                 layout=k.layout, batch=b, mode=m)
            for k, b, m in engine.last_group_stats]
    res["evolve_slots"] = any(g["kind"] == "evolve" and g["mode"] == "slots"
                              for g in res["groups"]["force"])
    check("never", timed("never_s", lambda: served(
        engine.evaluate_many(qs, shard="never"))), memory["answers"])
    res["modes"]["never"] = group_modes(engine.last_group_stats)
    if dense:
        forced_sw = timed("forced_sweeps_s", lambda: [
            store.evolve(**w, shard="force") for w in sw])
        res["bad"] += [f"forced sweep {w}" for w, x, y in zip(
            sw, forced_sw, memory["sweeps"]) if not same(x, y)]
    res["launches"] = dict(build.LAUNCHES)
    res["block_launches"] = dict(build.BLOCK_LAUNCHES)
    if dense:
        # the primitives, against their single-device values
        rows = shard_rows(store.current, mesh)
        d = store.delta()
        t_q = qmix[0][0]["t_k"]
        want = store.snapshot_at(t_q)
        g_t = timed("dist_reconstruct_s", lambda: D.dist_reconstruct(
            mesh, rows, d, store.t_cur, t_q))
        if not (torch.equal(torch.cat([b.adj.cpu() for b in g_t]),
                            want.adj.cpu())
                and torch.equal(torch.cat([b.nodes.cpu() for b in g_t]),
                                want.nodes.cpu())):
            res["bad"].append("dist_reconstruct")
        del g_t
        tri = timed("dist_triangles_s", lambda: int(D.dist_triangles(
            mesh, shard_rows(want, mesh))))
        tri_one = int(TQ.triangle_count(want))
        res["triangles"] = [tri, tri_one]
        if tri != tri_one:
            res["bad"].append(f"dist_triangles {tri} != {tri_one}")
        pts = [(q["v"], q["t_k"]) for q, _ in qmix
               if q["kind"] == "point" and q["measure"] == "degree"]
        vs = np.asarray([v for v, _ in pts], np.int32)
        ts = np.asarray([t for _, t in pts], np.int32)
        deg = timed("dist_batch_point_degree_s",
                    lambda: D.dist_batch_point_degree(
                        mesh, rows, d, vs, ts, store.t_cur).cpu().numpy())
        one = engine.evaluate_many(
            [Query("point", "node", "degree", t_k=int(t), v=int(v))
             for v, t in zip(vs, ts)], shard="never")
        if [int(x) for x in deg] != [int(x) for x in one]:
            res["bad"].append(f"dist_batch_point_degree {deg} != {one}")
        del rows, d, want
    res["peak_bytes"] = (sum(torch.cuda.max_memory_allocated(i)
                             for i in cards) if cuda else None)
    print(sharded_line(name, res), flush=True)
    bad = sharded_failures(res, layout)
    if bad:
        raise AssertionError("; ".join(bad))
    print(f"{name} sharded: {len(qs)} answers each auto, forced and never "
          f"sharded over {SHARDS} shards equal the in-memory session's bit "
          "for bit" + (", the sweeps and snapshot too, and the dist_* "
                       "primitives their single-device values"
                       if dense else ""), flush=True)
    return res


def sharded_failures(res: dict, layout: str) -> list:
    """Phase 10's verdict on one layout's results (``phase_sharded``):
    every failed check, named; empty when the phase passed."""
    name = f"{layout} sharded"
    bad = [f"{name}: {b}" for b in res["bad"]]
    forced = [m for run, modes in res["modes"].items()
              if run.startswith("force") for m in modes]
    if None in forced:
        bad.append(f"{name}: a forced group ran unsharded ({forced})")
    if set(res["modes"]["auto"]) != {None}:
        bad.append(f"{name}: shard='auto' sharded ({res['modes']['auto']})")
    want = {"rows", "batch"} if layout == "dense" else {"slots", "batch"}
    if not want <= set(forced):
        bad.append(f"{name}: forced modes {sorted(set(forced), key=str)} "
                   f"lack {sorted(want - set(forced))}")
    if set(res["modes"]["never"]) != {None}:
        bad.append(f"{name}: shard='never' sharded "
                   f"({res['modes']['never']})")
    if layout == "edge" and not res["evolve_slots"]:
        bad.append(f"{name}: no evolve group ran through evolve_slots")
    kernel = "delta_apply" if layout == "dense" else "edge_delta_apply"
    if res["block_launches"].get(kernel, 0) == 0:
        bad.append(f"{name}: {kernel} never launched on a "
                   f"{'row' if layout == 'dense' else 'slot'} block")
    if layout == "edge" and res["launches"].get("delta_apply", 0):
        bad.append(f"{name}: kernel delta_apply launched "
                   f"{res['launches']['delta_apply']} times on a path that "
                   "must not use it")
    return bad


def sharded_line(name: str, res: dict) -> str:
    """Phase 10's printed line: host seconds of each step (card
    synchronized), the shard modes of each run, launches (on blocks
    apart) and peak device memory."""
    return (f"{name} sharded over {res['mesh']}: "
            + ", ".join(f"{k} {v:.3f}" for k, v in res["steps"].items())
            + " s; modes " + "; ".join(
                f"{run} {sorted(set(m), key=str)}"
                for run, m in res["modes"].items())
            + f"; launches {res['launches']}, on blocks "
            f"{res['block_launches']}"
            + (f"; triangles {res['triangles']}" if "triangles" in res
               else "")
            + "; peak device memory "
            + (f"{res['peak_bytes'] / 2**30:.2f} GiB"
               if res["peak_bytes"] is not None else "not measured"))


# ---------------------------------------------------------------------------
# Phase 12: the paper's serving driver (launch/serve.py) on the card
# ---------------------------------------------------------------------------

# the driver's query batch at phase 12's size
SERVE_QUERIES = 1024


def serve_degree_oracle(ops, vs, ts):
    """deg(v, t) for each query (vs[i], ts[i]) from the op list alone:
    +1 for every addEdge, -1 for every remEdge touching v with time
    ≤ t, summed as prefix sums over the (node, time)-sorted edge ops —
    no store, no tensor."""
    import numpy as np

    from repro_torch.core.delta import ADD_EDGE, REM_EDGE
    a = np.array([(o.op, o.u, o.v, o.t) for o in ops], np.int64)
    e = a[np.isin(a[:, 0], (ADD_EDGE, REM_EDGE))]
    sign = np.where(e[:, 0] == ADD_EDGE, 1, -1)
    width = int(a[:, 3].max()) + 2
    key = np.concatenate([e[:, 1], e[:, 2]]) * width \
        + np.concatenate([e[:, 3], e[:, 3]]) + 1
    order = np.argsort(key, kind="stable")
    key = key[order]
    cum = np.concatenate([[0], np.cumsum(np.concatenate([sign, sign])
                                         [order])])
    vs = np.asarray(vs, np.int64)
    ts = np.asarray(ts, np.int64)
    hi = np.searchsorted(key, vs * width + ts + 1, side="right")
    lo = np.searchsorted(key, vs * width, side="right")
    return (cum[hi] - cum[lo]).astype(np.int32)


def phase_serve(nodes: int, queries: int, seed: int, device="cuda",
                meshes=None) -> dict:
    """Phase 12: ``repro_torch.launch.serve.main`` with ``--nodes
    nodes --queries queries --seed seed`` once on each mesh of
    ``meshes`` (default: every visible card, and ``cuda:0`` named four
    times), the launch counters zeroed just before each run and read
    just after.  Held: the point degrees bit-equal across the meshes and
    to ``serve_degree_oracle`` over the generator's op list, and the
    five mixed answers bit-equal across the meshes and to the same
    queries through the store's ``evaluate_many`` (its launches not
    counted).  Returns the times, launches and every failed check
    (``bad``), verdict in ``serve_failures``."""
    import numpy as np

    from repro_torch.core.generate import EvolutionParams, generate_ops
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.sharding import graph_mesh
    if meshes is None:
        meshes = {"visible": graph_mesh(), "cuda:0 x4":
                  graph_mesh(["cuda:0"] * 4)}
    argv = ["--nodes", str(nodes), "--queries", str(queries), "--seed",
            str(seed), "--device", device]
    runs = {}
    for name, mesh in meshes.items():
        _sync(device)
        build.reset_launches()
        t0 = time.perf_counter()
        out = serve.main(argv, mesh=mesh)
        _sync(device)
        runs[name] = dict(out=out, wall_s=time.perf_counter() - t0,
                          launches={k: n for k, n in build.LAUNCHES.items()
                                    if n})
    bad = []
    first, *rest = runs
    ref = runs[first]["out"]
    for name in rest:
        out = runs[name]["out"]
        if not (np.array_equal(out["vs"], ref["vs"])
                and np.array_equal(out["ts"], ref["ts"])):
            bad.append(f"{name}: another query batch than {first}'s")
        if not same(out["degrees"], ref["degrees"]):
            bad.append(f"{name}: point degrees differ from {first}'s")
        for q, a, b in zip(ref["mixed"], out["answers"], ref["answers"]):
            if not same(a, b):
                bad.append(f"{name}: {q} answered {a}, {first} {b}")
    t0 = time.perf_counter()
    ops = generate_ops(nodes, EvolutionParams(m_attach=4, lam_extra=1.0,
                                              lam_remove=1.0), seed)
    oracle = serve_degree_oracle(ops, ref["vs"], ref["ts"])
    oracle_s = time.perf_counter() - t0
    wrong = np.nonzero(ref["degrees"] != oracle)[0]
    if len(wrong) or ref["degrees"].dtype != np.int32:
        bad.append(f"point degrees differ from the op list's at "
                   f"{len(wrong)} of {len(oracle)} queries (first "
                   f"{wrong[:4].tolist()})")
    many = uncounted(lambda: ref["store"].evaluate_many(ref["mixed"]))
    for q, a, b in zip(ref["mixed"], ref["answers"], many):
        if not same(a, np.asarray(b)):
            bad.append(f"{q}: the driver answered {a}, evaluate_many {b}")
    return dict(nodes=nodes, queries=queries, stats=ref["store"].stats(),
                oracle_s=oracle_s, bad=bad, runs={
                    name: dict(mesh=[str(d) for d in r["out"]["mesh"]
                                     .devices],
                               build_s=r["out"]["build_s"],
                               batch_s=r["out"]["batch_s"],
                               mixed_s=r["out"]["mixed_s"],
                               wall_s=r["wall_s"], launches=r["launches"],
                               answers=[np.asarray(a).tolist()
                                        for a in r["out"]["answers"]])
                    for name, r in runs.items()})


def serve_failures(res: dict) -> list:
    """Phase 12's verdict (``phase_serve``): every failed check, named;
    empty when the phase passed.  Each run must launch a kernel."""
    bad = [f"serve: {b}" for b in res["bad"]]
    for name, r in res["runs"].items():
        if not r["launches"]:
            bad.append(f"serve: the driver launched no kernel on {name}")
    return bad


def serve_line(res: dict, smi: str) -> str:
    """Phase 12's printed line: each mesh's build, batch and mixed
    seconds and launches, beside the card's name and power limit."""
    return (f"serve ({smi}): {res['nodes']} nodes, {res['queries']} "
            f"point-degree queries; " + "; ".join(
                f"{name}: build {r['build_s']:.3f} s, batch "
                f"{1e3 * r['batch_s']:.3f} ms, mixed "
                f"{1e3 * r['mixed_s']:.3f} ms, launches {r['launches']}"
                for name, r in res["runs"].items())
            + f"; oracle {res['oracle_s']:.3f} s; mixed "
            f"{res['runs'][next(iter(res['runs']))]['answers']}")


# ---------------------------------------------------------------------------
# Phases 5 and 6: the decoder LMs
# ---------------------------------------------------------------------------


def _rel_err(a, b) -> float:
    """max |a − b| / max |b| over float32 copies."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def profile_device(fn, top: int = 8) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only) and
    return its wall time, the summed device time of the kernels it
    launched, the device's busy share of the wall time, the number of
    device kernels (copies and fills included) and those that took the
    most device time.  The profiler's own overhead is in the wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = list(prof.key_averages())
    device_s = sum(dev_us(e) for e in events) / 1e6
    events.sort(key=dev_us, reverse=True)
    return dict(wall_s=wall, device_s=device_s,
                busy=device_s / wall if wall else None,
                kernels=sum(e.count for e in events),
                top_ms=[(e.key[:80], dev_us(e) / 1e3, e.count)
                        for e in events[:top]])


def layer_outputs(model, cfg, tokens) -> list:
    """(name, float64 copy) of the embeddings, every layer's output and
    the logits of one forward over ``tokens``, as ``models/lm.py``'s
    ``forward`` computes them."""
    import torch

    from repro_torch.models import blocks
    from repro_torch.models.layers import apply_norm, embed, unembed
    outs = []
    with torch.no_grad():
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = embed(model.embed, tokens.long(), cfg, positions=pos)
        outs.append(("embed", x.cpu().double()))
        for i, g in enumerate(model.groups):
            x, _ = blocks.apply_group(g, x, cfg, positions=pos.int())
            outs.append((f"layer {i}", x.cpu().double()))
        x = apply_norm(model.final_norm, x, cfg.norm_kind)
        outs.append(("logits", unembed(model.embed, x, cfg).cpu().double()))
    return outs


def float64_drift(cpu, card, cfg, tokens) -> list[dict]:
    """Where the float32 card and the float32 CPU part: both read
    against a float64 copy of the same weights on the CPU, output by
    output (embeddings, each layer, logits), as max |Δ| / max |ref|.
    Side by side, the two distances show which device's path drifts
    from float64, and from which layer on."""
    import copy

    ref = copy.deepcopy(cpu).double()
    want = layer_outputs(ref, cfg, tokens)
    del ref
    got_card = layer_outputs(card, cfg, tokens.cuda())
    got_cpu = layer_outputs(cpu, cfg, tokens)
    rows = []
    for (name, w), (_, a), (_, b) in zip(want, got_card, got_cpu):
        scale = float(w.abs().max().clamp_min(1e-300))
        rows.append(dict(output=name,
                         card=float((a - w).abs().max()) / scale,
                         cpu=float((b - w).abs().max()) / scale,
                         card_cpu=float((a - b).abs().max()) / scale))
    return rows


def lm_config(arch: str, layers: int):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def greedy(api, model, cfg, tokens, n_steps: int, cache_cap: int,
           after_prefill=None, extra=None, offset: int = 0,
           before_step=None):
    """Prefill ``tokens`` (with the batch's ``extra`` inputs: ``frames``
    or ``patches``) then ``n_steps`` greedy decode steps at absolute
    positions ``offset`` + len + i (vlm: ``offset`` = its patch count),
    calling ``after_prefill()`` between the two and ``before_step(i,
    caches)`` before step i.  Returns (generated [B, n_steps + 1],
    logits of every step, caches)."""
    import torch
    logits, caches = api.prefill(model, {"tokens": tokens, **(extra or {})},
                                 cfg, cache_cap=cache_cap)
    if after_prefill:
        after_prefill()
    out, steps = [logits.argmax(-1)], [logits]
    for i in range(n_steps):
        if before_step:
            before_step(i, caches)
        logits, caches = api.decode_step(model, out[-1][:, None],
                                         offset + tokens.shape[1] + i,
                                         caches, cfg)
        out.append(logits.argmax(-1))
        steps.append(logits)
    return torch.stack(out, 1), steps, caches


def stub_inputs(cfg, seed: int):
    """The modality-stub input of ``cfg``'s family, as ``make(n, dtype,
    device) → {name: [n, rows, d]}``: ``frames`` [n, enc_seq, d] for
    encdec, ``patches`` [n, n_patches, d] for vlm, seeded standard normal
    drawn in float32 on the CPU and then cast (so sequence 0 is the same
    for any n, dtype and device); None for the other families."""
    import torch

    from repro_torch.data.synthetic import stub_rows
    stub = stub_rows(cfg)
    if not stub:
        return None
    (name, rows), = stub.items()

    def make(n: int, dtype, device) -> dict:
        x = torch.randn((n, rows, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed))
        return {name: x.to(device=device, dtype=dtype)}
    return make


def f32_check_config(cfg, layers: int = F32_CHECK_LAYERS):
    """``cfg`` at most ``layers`` deep: F32_CHECK_LAYERS for phases 5, 6
    and 14's float32 and promotion checks, ``dense_check_layers``' for
    phase 18's."""
    return at_depth(cfg, min(cfg.n_layers, layers))


def f32_pair(cfg, seed: int, device) -> tuple:
    """The float32 card-versus-CPU checks' two copies of one seeded draw
    of ``cfg``'s weights: (on the CPU, on ``device``).  The draw is made
    on ``device`` and each parameter copied to the CPU, so both start
    from the same bits: the CPU's generator draws one value after
    another, and glm4-9b's or mixtral-8x7b's float32 checks draw ~1.7 G
    values (phase 13's took 61.1 s against 86.3 s drawn on the CPU, on
    one H100 80GB HBM3 at 700 W)."""
    import copy

    import torch

    from repro_torch.models import api
    card = api.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(seed), torch.float32, device)
    return copy.deepcopy(card, {
        id(p): torch.nn.Parameter(p.detach().cpu(),
                                  requires_grad=p.requires_grad)
        for p in card.parameters()}), card


def prefill_launches_want(cfg, kernel: str) -> dict:
    """``kernel``'s launches in one prefill: one a layer; an
    encoder-decoder's encoder layers and its decoder's self- and
    cross-attention each once a layer."""
    if cfg.family == "encdec":
        return {kernel: cfg.n_enc_layers + 2 * cfg.n_layers}
    return {kernel: cfg.n_layers}


def phase_lm(cfg, kernel: str, seed: int, *, extra=None, offset: int = 0,
             prompt: int = LM_PROMPT,
             device="cuda", batch: int = LM_BATCH, decode: int = LM_DECODE,
             check_prompt: int = CHECK_PROMPT,
             check_decode: int = CHECK_DECODE,
             check_layers: int = F32_CHECK_LAYERS,
             check_cut: str = "F32_CHECK_LAYERS") -> dict:
    """Serve ``cfg`` (its width, its depth) in bf16 on ``device``, then
    the float32 ``device``-versus-CPU check at most ``check_layers`` deep
    (the cut printed as ``check_cut``); a prefill must launch
    ``kernel`` as ``prefill_launches_want`` says.  ``extra``: the batch's
    stub input as ``stub_inputs`` makes it (bf16
    on the main path, float32 in the check; sequence 0's for the fresh
    forward); ``offset``: the absolute position of the first token (the
    vlm's patch count).  Phases 5, 6, 14 and 18; the verdict is
    ``family_failures``."""
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api

    on_card = torch.device(device).type == "cuda"
    arch = cfg.name
    want = prefill_launches_want(cfg, kernel)
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed), torch.bfloat16, device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt))).to(device)
    ex = extra(batch, torch.bfloat16, device) if extra else {}
    cap = offset + prompt + decode

    # the main path: prefill, then greedy decode; the clock and the
    # counters are read after each
    marks = []

    def mark():
        _sync(device)
        marks.append((time.perf_counter(), dict(build.LAUNCHES)))
        build.reset_launches()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    gen, steps, caches = greedy(api, model, cfg, prompts, decode, cap,
                                after_prefill=mark, extra=ex, offset=offset)
    mark()
    (t1, prefill_launches), (t2, decode_launches) = marks
    prefill_cold_s, decode_s = t1 - t0, t2 - t1
    peak_gib = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None)
    finite = all(bool(torch.isfinite(t).all()) for t in steps)
    dec_logits = [t[0] for t in steps[1:]]
    del caches, steps

    # a warm prefill for the rate (same inputs, counters not read), then
    # where the device time goes in one prefill and in 8 decode steps
    t0 = time.perf_counter()
    _, caches = api.prefill(model, {"tokens": prompts, **ex}, cfg,
                            cache_cap=cap)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prof_prefill = prof_decode = None
    if on_card:
        prof_prefill = profile_device(lambda: api.prefill(
            model, {"tokens": prompts, **ex}, cfg, cache_cap=cap))

        def decode8():
            t = gen[:, :1]
            for i in range(8):
                logits, _ = api.decode_step(model, t, offset + prompt + i,
                                            caches, cfg)
                t = logits.argmax(-1)[:, None]
        prof_decode = profile_device(decode8)
        for what, pr in (("prefill", prof_prefill), ("8 decode steps",
                                                     prof_decode)):
            print(f"{arch} profile, {what}: wall {pr['wall_s']:.4f} s, "
                  f"device {pr['device_s']:.4f} s, busy {pr['busy']:.3f}; "
                  "top " + "; ".join(f"{k} {ms:.2f} ms x{n}"
                                     for k, ms, n in pr["top_ms"]),
                  flush=True)
    del caches

    # decode against a fresh forward over prompt + generated, sequence 0
    with torch.no_grad():
        seq = torch.cat([prompts[:1], gen[:1, :decode]], 1)
        full = api.forward(model, {"tokens": seq, **{
            k: v[:1] for k, v in ex.items()}}, cfg)[0]
    step_rel = [_rel_err(dl, full[prompt + i])
                for i, dl in enumerate(dec_logits)]
    decode_rel = max(step_rel)
    greedy_same = float((full[prompt - 1:].argmax(-1)
                         == gen[0, :decode + 1]).float().mean())
    peak = f"{peak_gib:.2f} GiB" if peak_gib is not None else "n/a"
    print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, prefill "
          f"{batch}x{prompt} in {prefill_s:.4f} s "
          f"({batch * prompt / prefill_s:.0f} tokens/s; cold "
          f"{prefill_cold_s:.4f} s), decode {1e3 * decode_s / decode:.3f}"
          f" ms/step, peak {peak}; {kernel} launches per "
          f"prefill {prefill_launches.get(kernel, 0)}; decode vs fresh "
          f"forward rel err first step {step_rel[0]:.3g} (tolerance "
          f"{BF16_FIRST_STEP_RTOL:.3g}), all steps {decode_rel:.3g} "
          f"(tolerance {BF16_DECODE_RTOL:.3g}), greedy agreement "
          f"{greedy_same:.3f}", flush=True)
    del model, full, dec_logits
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # float32: the same model on the device and on the CPU, at most
    # check_layers deep
    t0 = time.perf_counter()
    fcfg = f32_check_config(cfg, check_layers)
    cpu, card = f32_pair(fcfg, seed, device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, check_prompt)))
    ex32 = extra(1, torch.float32, "cpu") if extra else {}
    ex32_card = {k: v.to(device) for k, v in ex32.items()}
    cap = offset + check_prompt + check_decode
    build.reset_launches()
    g_card, s_card, _ = greedy(api, card, fcfg, toks.to(device), check_decode,
                               cap, extra=ex32_card, offset=offset)
    _sync(device)
    f32_launches = build.LAUNCHES[kernel]
    g_cpu, s_cpu, _ = greedy(api, cpu, fcfg, toks, check_decode, cap,
                             extra=ex32, offset=offset)
    f32_rel = max(_rel_err(a.cpu(), b) for a, b in zip(s_card, s_cpu))
    same = bool(torch.equal(g_card.cpu(), g_cpu))
    f32_s = time.perf_counter() - t0
    witness = ""
    plain_rel = drift = None
    if fcfg.family == "ssm":
        # witness: the same float32 run on the card with the plain
        # chunked scan (the CPU's path) in the kernel's place
        from repro_torch.models import ssm as ssm_module
        kernel_scan = ssm_module.ssd_scan
        ssm_module.ssd_scan = ssm_module.ssd_chunked
        try:
            _, s_plain, _ = greedy(api, card, fcfg, toks.to(device),
                                   check_decode, cap)
        finally:
            ssm_module.ssd_scan = kernel_scan
        plain_rel = max(_rel_err(a.cpu(), b) for a, b in zip(s_plain, s_cpu))
        witness = (f"; with the plain chunked scan on the card instead of "
                   f"the kernel: rel err {plain_rel:.3g}")
        drift = float64_drift(cpu, card, fcfg, toks)
        print(f"{arch}: float32 against a float64 copy on the CPU, prompt "
              f"{check_prompt}, max|Δ|/max|ref| card / CPU (card vs CPU): "
              + ", ".join(f"{r['output']} {r['card']:.3g} / {r['cpu']:.3g}"
                          f" ({r['card_cpu']:.3g})" for r in drift),
              flush=True)
    print(f"{arch}: float32 card vs CPU, {fcfg.n_layers} of "
          f"{cfg.n_layers} layers ({check_cut}, cut for the "
          f"script's time), prompt {check_prompt} + "
          f"{check_decode} steps: rel err {f32_rel:.3g} (tolerance "
          f"{F32_CARD_CPU_RTOL:.3g}), greedy tokens identical: {same} "
          f"({f32_s:.1f} s){witness}", flush=True)
    del card, cpu
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(arch=arch, family=cfg.family, kernel=kernel,
                n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                d_model=cfg.d_model, params=n_params, batch=batch,
                prompt=prompt, decode=decode, offset=offset,
                stub={k: list(v.shape) for k, v in ex.items()},
                init_s=init_s, prefill_s=prefill_s,
                prefill_cold_s=prefill_cold_s,
                prefill_tokens_per_s=batch * prompt / prefill_s,
                decode_ms_per_step=1e3 * decode_s / decode,
                peak_gib=peak_gib, want_launches=want,
                prefill_launches=prefill_launches,
                decode_launches=decode_launches, finite=finite,
                decode_rel_err=decode_rel, decode_rel_err_by_step=step_rel,
                profile_prefill=prof_prefill, profile_decode8=prof_decode,
                greedy_agreement=greedy_same, f32_launches=f32_launches,
                f32_n_layers=fcfg.n_layers,
                f32_want_launches=prefill_launches_want(fcfg, kernel),
                f32_rel_err=f32_rel, f32_plain_scan_rel_err=plain_rel,
                f32_float64_drift=drift, f32_greedy_identical=same,
                f32_check_s=f32_s, generated=gen[0].tolist())


def family_failures(res: dict) -> list:
    """The serving verdict of phases 5, 6 and 14 on ``phase_lm``'s /
    ``phase_family``'s result: every failed check, named; empty when it
    passed.  (a) the prefill launches each kernel as ``want_launches``
    says, decode none; (b) bf16 decode against a fresh forward:
    the first step within BF16_FIRST_STEP_RTOL, every step within
    BF16_DECODE_RTOL; (c) float32 on the card against the CPU within
    F32_CARD_CPU_RTOL with the same greedy tokens, the float32 prefill
    launching the kernel as often; (d), where it ran (``promotion``):
    B5's launches by dtype, the outputs' dtypes, the float32 outputs
    within F32_CARD_CPU_RTOL of the CPU's and the bf16 decoder's logits
    within BF16_FIRST_STEP_RTOL."""
    bad = []
    want, pre = res["want_launches"], res["prefill_launches"]
    for k in sorted(set(want) | {k for k, n in pre.items() if n}):
        if pre.get(k, 0) != want.get(k, 0):
            bad.append(f"a prefill launched {k} {pre.get(k, 0)} times, "
                       f"want {want.get(k, 0)}")
    if any(res["decode_launches"].values()):
        bad.append(f"decode launched {res['decode_launches']}")
    if not res["finite"]:
        bad.append("non-finite logits")
    rel = res["decode_rel_err_by_step"]
    if not (rel[0] <= BF16_FIRST_STEP_RTOL
            and all(r <= BF16_DECODE_RTOL for r in rel)):
        bad.append(f"bf16 decode disagrees with a fresh forward (rel err "
                   f"per step {[round(r, 5) for r in rel]})")
    k = res["kernel"]
    want32 = res["f32_want_launches"].get(k, 0)
    if res["f32_launches"] != want32:
        bad.append(f"float32 prefill launched {k} {res['f32_launches']} "
                   f"times, want {want32}")
    if not (res["f32_rel_err"] <= F32_CARD_CPU_RTOL
            and res["f32_greedy_identical"]):
        bad.append(f"float32 card and CPU disagree (rel err "
                   f"{res['f32_rel_err']:.3g}, greedy tokens identical: "
                   f"{res['f32_greedy_identical']})")
    pr = res.get("promotion")
    if pr:
        total = pr["launches"].get(k, 0)
        if total != pr["want_total"]:
            bad.append(f"the mixed-dtype prefill launched {k} {total} "
                       f"times, want {pr['want_total']}")
        if sorted(map(tuple, pr["by_dtype"])) != sorted(
                map(tuple, pr["want_by_dtype"])):
            bad.append(f"the mixed-dtype prefill ran B5 as (dtype, causal, "
                       f"Sq, Skv, calls) {pr['by_dtype']}, want "
                       f"{pr['want_by_dtype']}")
        if pr["dtypes"] != pr["want_dtypes"]:
            bad.append(f"mixed-dtype outputs {pr['dtypes']}, want "
                       f"{pr['want_dtypes']}")
        for name in ("encoder", "xk", "xv"):
            if not pr["rel"][name] <= F32_CARD_CPU_RTOL:
                bad.append(f"the mixed-dtype prefill's float32 {name} "
                           f"differs from the CPU's by "
                           f"{pr['rel'][name]:.3g} (tolerance "
                           f"{F32_CARD_CPU_RTOL:.3g})")
        if not pr["rel"]["logits"] <= BF16_FIRST_STEP_RTOL:
            bad.append(f"the mixed-dtype prefill's logits differ from the "
                       f"CPU's by {pr['rel']['logits']:.3g} (tolerance "
                       f"{BF16_FIRST_STEP_RTOL:.3g})")
    return [f"{res['arch']}: {b}" for b in bad]


# ---------------------------------------------------------------------------
# Phase 14: the encoder-decoder (whisper-small) and the vlm (internvl2-1b)
# served on the card
# ---------------------------------------------------------------------------

def promotion_check(cfg, seed: int, device="cuda",
                    prompt: int = CHECK_PROMPT) -> dict:
    """Phase 14 (d): one encoder-decoder prefill of one sequence with
    float32 frames under bf16 weights, the training dtypes, on
    ``device`` and on the CPU (the same bits, copied).  JAX promotes the
    encoder to float32, and so the cross keys / values and the
    cross-attention (its bf16 queries against float32 keys), while the
    decoder's self-attention and activations stay bf16.  Read: the
    kernel's launches (``build.LAUNCHES``) and B5's calls by (dtype,
    causal, Sq, Skv), counted around ``models.attention.flash_attention``;
    the outputs' dtypes; max |Δ| / max |CPU| of the encoder output, the
    cross keys and values (float32) and the logits."""
    import collections
    import copy

    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api, encdec
    from repro_torch.models import attention as attn

    model = api.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed), torch.bfloat16, device)
    cpu = copy.deepcopy(model).to("cpu")
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (1, prompt)))
    frames = stub_inputs(cfg, seed + 1)(1, torch.float32, "cpu")["frames"]
    calls = collections.Counter()
    kernel = attn.flash_attention

    def counted(q, k, v, causal=True, *args, **kw):
        calls[(str(q.dtype)[6:], bool(causal), q.shape[2], k.shape[2])] += 1
        return kernel(q, k, v, causal, *args, **kw)

    attn.flash_attention = counted
    try:
        build.reset_launches()
        logits, caches = encdec.prefill(model, toks.to(device),
                                        frames.to(device), cfg,
                                        cache_cap=prompt)
        _sync(device)
        launches = dict(build.LAUNCHES)
        by_dtype = [[*key, n] for key, n in sorted(calls.items())]
    finally:
        attn.flash_attention = kernel
    with torch.no_grad():
        enc = encdec.encode(model, frames.to(device), cfg)
        enc_cpu = encdec.encode(cpu, frames, cfg)
    logits_cpu, caches_cpu = encdec.prefill(cpu, toks, frames, cfg,
                                            cache_cap=prompt)
    e, p = cfg.enc_seq, prompt
    rel = dict(
        encoder=_rel_err(enc.cpu(), enc_cpu),
        xk=max(_rel_err(a["xk"].cpu(), b["xk"])
               for a, b in zip(caches, caches_cpu)),
        xv=max(_rel_err(a["xv"].cpu(), b["xv"])
               for a, b in zip(caches, caches_cpu)),
        logits=_rel_err(logits.cpu(), logits_cpu))
    dtypes = {name: sorted({str(t.dtype)[6:] for t in ts}) for name, ts in (
        ("encoder", [enc, enc_cpu]),
        ("xk/xv", [c[n] for c in caches + caches_cpu for n in ("xk", "xv")]),
        ("self-KV", [t for c in caches + caches_cpu
                     for t in (c["self"].k, c["self"].v)]),
        ("logits", [logits, logits_cpu]))}
    res = dict(
        prompt=prompt, launches=launches,
        want_total=cfg.n_enc_layers + 2 * cfg.n_layers,
        by_dtype=by_dtype,
        want_by_dtype=sorted([["float32", False, e, e, cfg.n_enc_layers],
                              ["bfloat16", True, p, p, cfg.n_layers],
                              ["float32", False, p, e, cfg.n_layers]]),
        dtypes=dtypes,
        want_dtypes={"encoder": ["float32"], "xk/xv": ["float32"],
                     "self-KV": ["bfloat16"], "logits": ["float32"]},
        rel=rel)
    del model, cpu, caches, caches_cpu, enc, enc_cpu
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_family(cfg, seed: int, prompt: int, device="cuda",
                 batch: int = LM_BATCH, decode: int = LM_DECODE,
                 check_prompt: int = CHECK_PROMPT,
                 check_decode: int = CHECK_DECODE) -> dict:
    """Phase 14 on one model: ``phase_lm`` with the family's stub input
    (bf16 frames or patches, seeded), the vlm's positions offset by its
    patches and B5 launched once a layer (an encoder-decoder: 12 encoder
    + 12 decoder self + 12 cross a prefill), plus, for the
    encoder-decoder, ``promotion_check``.  The verdict is
    ``family_failures``."""
    res = phase_lm(cfg, "flash_attention", seed,
                   extra=stub_inputs(cfg, seed),
                   offset=cfg.n_patches if cfg.family == "vlm" else 0,
                   prompt=prompt, device=device, batch=batch, decode=decode,
                   check_prompt=check_prompt, check_decode=check_decode)
    if cfg.family == "encdec":
        t0 = time.perf_counter()
        res["promotion"] = promotion_check(f32_check_config(cfg), seed,
                                           device, check_prompt)
        res["promotion"]["seconds"] = time.perf_counter() - t0
    return res


def family_lines(res: dict, smi: str) -> list:
    """Phase 14's own printed lines, the card's name and power limit
    beside its times (``phase_lm`` prints the profiles, the decode check
    and the float32 check)."""
    (name, (_, rows, _)), = res["stub"].items()
    b, s = res["batch"], res["prompt"]
    enc = (f" + {res['n_enc_layers']} encoder layers"
           if res["family"] == "encdec" else "")
    rate = f"{b * s / res['prefill_s']:.0f} decoder tokens/s"
    cold = f"{b * s / res['prefill_cold_s']:.0f}"
    if res["family"] == "encdec":
        rate += f" and {b * rows / res['prefill_s']:.0f} encoder frames/s"
        cold += f" and {b * rows / res['prefill_cold_s']:.0f}"
    peak = (f"{res['peak_gib']:.2f} GiB" if res["peak_gib"] is not None
            else "n/a")
    lines = [
        f"{res['arch']} [{res['family']}] on {smi}: {res['n_layers']} "
        f"layers{enc}, d {res['d_model']}, {res['params'] / 1e6:.1f} M "
        f"params, peak {peak}; prefill {b}x{s} tokens + {b}x{rows} {name} "
        f"in {res['prefill_s']:.4f} s ({rate}; cold "
        f"{res['prefill_cold_s']:.4f} s, {cold}), decode "
        f"{res['decode_ms_per_step']:.3f} ms/step from position "
        f"{res['offset'] + s}; launches per prefill "
        f"{ {k: n for k, n in res['prefill_launches'].items() if n} }, "
        f"decode {sum(res['decode_launches'].values())}"]
    pr = res.get("promotion")
    if pr:
        lines.append(
            f"{res['arch']}: float32 frames under bf16 weights, 1 x "
            f"{pr['prompt']} tokens + {rows} frames, card vs CPU: B5 by "
            f"(dtype, causal, Sq, Skv, calls) {pr['by_dtype']} (want "
            f"{pr['want_by_dtype']}), launches "
            f"{pr['launches'].get('flash_attention', 0)}; dtypes {pr['dtypes']}; rel err "
            + ", ".join(f"{k} {v:.3g}" for k, v in pr["rel"].items())
            + f" (tolerance {F32_CARD_CPU_RTOL:.3g} for the float32 "
            f"outputs, {BF16_FIRST_STEP_RTOL:.3g} for the logits) "
            f"({pr['seconds']:.1f} s)")
    return lines


# ---------------------------------------------------------------------------
# Phase 18: gemma-2b, olmo-1b and glm4-9b (the dense family's other
# configurations) served on the card


DENSE_ARCHS = ("gemma-2b", "olmo-1b", "glm4-9b")
# phase 18's float32 card-vs-CPU checks: the CPU side is host-bound, and a
# decode step there reads the float32 layers and the unembedding (glm4-9b
# ~0.82 GB a layer and a 2.48 GB table; gemma-2b ~0.44 GB and 2.10 GB;
# olmo-1b ~0.27 GB and 0.41 GB).  Each check runs as deep as keeps a step
# within DENSE_CHECK_STEP_BYTES (at most F32_CHECK_LAYERS, at least one
# layer) and DENSE_CHECK_DECODE of the LM_DECODE steps, cut for the
# script's time: at 6 layers and 32 steps the three would read ~560 GB
# on the CPU
DENSE_CHECK_STEP_BYTES = 4.2e9
DENSE_CHECK_DECODE = 8


def f32_step_bytes(cfg, layers: int) -> int:
    """The float32 weights a CPU decode step of ``cfg`` at ``layers``
    layers reads: those layers (attention, MLP or experts, norms) and the
    unembedding table (the tied embedding or its own).  A MoE layer's
    step reads its router and every expert: ``models.moe.experts`` runs
    each one over its capacity's slots (8 at a decode step), whether a
    token chose it or not."""
    d, hd, e = cfg.d_model, cfg.hd(), cfg.n_experts
    attn = d * hd * 2 * (cfg.n_heads + cfg.n_kv_heads)
    mlp = ((3 if cfg.mlp_kind in ("swiglu", "geglu") else 2) * d * cfg.d_ff
           * (e or 1) + d * e)
    norms = {"ln_nonparam": 0, "rms": 2 * d, "ln": 4 * d}[cfg.norm_kind]
    return 4 * (layers * (attn + mlp + norms) + cfg.vocab * d)


def dense_check_layers(cfg) -> int:
    """Phase 18's float32 check depth for ``cfg``: the most layers, at
    most F32_CHECK_LAYERS and at least one, whose CPU decode step reads
    at most DENSE_CHECK_STEP_BYTES (``f32_step_bytes``)."""
    n = min(cfg.n_layers, F32_CHECK_LAYERS)
    while n > 1 and f32_step_bytes(cfg, n) > DENSE_CHECK_STEP_BYTES:
        n -= 1
    return n


def allocated_now(device) -> int:
    """The card's memory allocated once the collector has run and
    cuBLAS's workspaces are let go (0 off the card): a model's first
    product on a stream allocates a workspace (32 MiB under
    CUBLAS_WORKSPACE_CONFIG :4096:8) that cuBLAS keeps, as PyTorch's own
    leak check knows."""
    import torch
    gc.collect()
    if torch.device(device).type != "cuda":
        return 0
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def phase_dense(cfg, seed: int, device="cuda", batch: int = LM_BATCH,
                prompt: int = LM_PROMPT, decode: int = LM_DECODE,
                check_prompt: int = CHECK_PROMPT,
                check_decode: int = DENSE_CHECK_DECODE) -> dict:
    """Phase 18 on one model: ``phase_lm`` (B5 once a layer a prefill,
    none in decode), its float32 check ``dense_check_layers`` deep over
    ``check_decode`` steps, the cut printed; the card's memory allocated
    read before and after (the model must leave no more than it found).
    The verdict is ``dense_failures``."""
    before = allocated_now(device)
    layers = dense_check_layers(cfg)
    cut = (f"float32 check {layers} of {cfg.n_layers} layers "
           f"({f32_step_bytes(cfg, layers) / 1e9:.2f} GB a CPU decode step "
           f"within DENSE_CHECK_STEP_BYTES {DENSE_CHECK_STEP_BYTES / 1e9:.1f}"
           f" GB), {check_decode} of {decode} steps (DENSE_CHECK_DECODE), "
           f"cut for the script's time")
    print(f"{cfg.name}: {cut}", flush=True)
    res = phase_lm(cfg, "flash_attention", seed, device=device, batch=batch,
                   prompt=prompt, decode=decode, check_prompt=check_prompt,
                   check_decode=check_decode, check_layers=layers,
                   check_cut="DENSE_CHECK_STEP_BYTES")
    res.update(cut=cut, allocated_before=before,
               allocated_after=allocated_now(device))
    return res


def dense_failures(res: dict) -> list:
    """Phase 18's verdict on one model: ``family_failures``, and no more
    of the card's memory allocated after the model than before it."""
    bad = family_failures(res)
    grew = res["allocated_after"] - res["allocated_before"]
    if grew > 0:
        bad.append(f"{res['arch']}: {grew} B more allocated after the "
                   f"model than before it")
    return bad


def dense_line(res: dict, smi: str) -> str:
    """Phase 18's own printed line, the card's name and power limit
    beside its times (``phase_lm`` prints the profiles, the decode check
    and the float32 check)."""
    b, s = res["batch"], res["prompt"]
    peak = (f"{res['peak_gib']:.2f} GiB" if res["peak_gib"] is not None
            else "n/a")
    return (f"{res['arch']} [dense] on {smi}: {res['n_layers']} layers, d "
            f"{res['d_model']}, {res['params'] / 1e6:.1f} M params, peak "
            f"{peak}; prefill {b}x{s} in {res['prefill_s']:.4f} s "
            f"({b * s / res['prefill_s']:.0f} tokens/s; cold "
            f"{res['prefill_cold_s']:.4f} s, "
            f"{b * s / res['prefill_cold_s']:.0f}), decode "
            f"{res['decode_ms_per_step']:.3f} ms/step; launches per prefill "
            f"{ {k: n for k, n in res['prefill_launches'].items() if n} }, "
            f"decode {sum(res['decode_launches'].values())}; allocated "
            f"before {res['allocated_before']} B, after "
            f"{res['allocated_after']} B; {res['cut']}")


# ---------------------------------------------------------------------------
# Phase 13: mixtral-8x7b (the MoE family) served on the card


MOE_ARCH = "mixtral-8x7b"
# 24 of the 32 layers: one layer is 2.90 GB of bf16 (8 × 3 × 4096 ×
# 14336 expert weights and 41.9 M attention weights), the embed and
# unembed 0.52 GB, so 24 layers hold 70.2 GB = 65.4 GiB of the card's
# 79.2; the depth steps down by 4 while the weights and
# MOE_TRANSIENT_BYTES exceed the card's free memory
MOE_LAYERS, MOE_LAYER_STEP = 24, 4
# a prefill's activations, KV caches and expert intermediates at 8 ×
# 2048 tokens (read on the card at 8 layers: a 27.97 GiB peak over 22.1
# GiB of weights)
MOE_TRANSIENT_BYTES = 8 * 2 ** 30
# more than this still allocated when phase 13 starts fails it: a model
# of ~70 GB needs the memory that earlier phases held
MOE_START_ALLOCATED = 2 * 2 ** 30
# (c)'s float32 half and (d): 1 layer at full width, 5.8 GB in float32
# (its CPU half sets the phase's time: 2 layers took ~50 s)
MOE_F32_LAYERS = 1


def moe_weight_bytes(cfg) -> int:
    """Bytes of ``cfg``'s LM weights in bf16, the MoE router in float32,
    every MoE layer with experts of its own."""
    return hybrid_weight_bytes(cfg, n_moe_layers(cfg))


def moe_depth(cfg, free_bytes: int, override: int = 0) -> tuple:
    """Phase 13's depth and the reason for the cut, as printed: ``override``
    (``--lm-layers``) if given, else MOE_LAYERS, stepped down by
    MOE_LAYER_STEP while the weights and MOE_TRANSIENT_BYTES exceed
    ``free_bytes``."""
    import dataclasses
    full = moe_weight_bytes(cfg) / 1e9
    if override:
        return override, (f"{override} of {cfg.n_layers} layers "
                          f"(--lm-layers)")
    n = MOE_LAYERS
    while n > MOE_LAYER_STEP and moe_weight_bytes(dataclasses.replace(
            cfg, n_layers=n)) + MOE_TRANSIENT_BYTES > free_bytes:
        n -= MOE_LAYER_STEP
    held = moe_weight_bytes(dataclasses.replace(cfg, n_layers=n)) / 1e9
    why = (f"{n} of {cfg.n_layers} layers: {cfg.n_layers} layers are "
           f"{full:.1f} GB of bf16 weights, {n} are {held:.1f} GB, with "
           f"{MOE_TRANSIENT_BYTES / 2 ** 30:.0f} GiB for activations, of "
           f"{free_bytes / 2 ** 30:.1f} GiB free")
    if n < MOE_LAYERS:
        why += f" (stepped down from {MOE_LAYERS}: {MOE_LAYERS} do not fit)"
    return n, why


class moe_inputs:
    """Forward hooks on every MoE module of ``model``, in layer order:
    inside the ``with``, each MoE call's input goes to ``fn(layer,
    module, x)``, and a value ``fn`` returns other than None replaces the
    call's output.  The model path takes no argument for it."""

    def __init__(self, model, fn):
        from repro_torch.models.moe import MoE
        self.mods = [m for m in model.modules() if isinstance(m, MoE)]
        self.fn, self.hooks = fn, []

    def __enter__(self):
        for i, m in enumerate(self.mods):
            self.hooks.append(m.register_forward_hook(
                lambda mod, args, out, i=i: self.fn(i, mod, args[0])))
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        self.hooks = []


def routing_readout(model, cfg, tokens, cache_cap: int) -> dict:
    """One prefill of ``tokens`` with hooks on the MoE modules: per layer,
    the (token, choice) pairs, those dropped at ``cfg``'s capacity, and
    the fullest expert's pairs beside that capacity."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.moe import route
    rows = []

    def read(layer, mod, x):
        r = route(mod, x.reshape(-1, x.shape[-1]), cfg)
        load = torch.bincount(r.topi.reshape(-1), minlength=cfg.n_experts)
        rows.append(dict(layer=layer, pairs=r.keep.numel(),
                         dropped=int((~r.keep).sum()),
                         fullest=int(load.max()), cap=r.cap))
    with torch.no_grad(), moe_inputs(model, read):
        api.prefill(model, {"tokens": tokens}, cfg, cache_cap=cache_cap)
    pairs = sum(r["pairs"] for r in rows)
    dropped = sum(r["dropped"] for r in rows)
    return dict(per_layer=rows, pairs=pairs, dropped=dropped,
                dropped_share=dropped / pairs if pairs else 0.0,
                fullest=max(r["fullest"] for r in rows),
                cap=rows[0]["cap"],
                layers_dropping=sum(1 for r in rows if r["dropped"]))


def pinned_step(model, cfg, token, pos: int, caches, pins: dict) -> tuple:
    """One decode step of ``token`` [B, 1] at ``pos`` that routes sequence
    0's token, at each MoE layer in ``pins``, to the experts
    ``pins[layer]`` in place of its own top-k (the other tokens route as
    usual): (logits, sequence 0's router logits by layer).  The step
    writes its key / value row into ``caches`` as every decode step
    does; the causal mask hides the rows of later positions."""
    from repro_torch.models import api
    from repro_torch.models.moe import apply_routed, route, route_to
    seen = {}

    def hook(layer, mod, x):
        r = route(mod, x.reshape(-1, x.shape[-1]), cfg)
        seen[layer] = r.logits[0]
        if layer in pins:
            topi = r.topi.clone()
            topi[0] = pins[layer]
            return apply_routed(mod, x, route_to(r.logits, topi, cfg), cfg)
        return None
    with moe_inputs(model, hook):
        logits, _ = api.decode_step(model, token, pos, caches, cfg)
    return logits, seen


def route_flip(dl, fl, k: int):
    """None if router logits ``dl`` (decode) and ``fl`` (forward) choose
    the same k experts, else the forward's gap between its k-th and
    (k+1)-th logits, the largest |Δ router logit| and whether the flip
    is a near-tie (gap ≤ Δ)."""
    import torch
    fs = torch.sort(fl, descending=True, stable=True)
    ds = torch.sort(dl, descending=True, stable=True)
    if set(fs.indices[:k].tolist()) == set(ds.indices[:k].tolist()):
        return None
    gap = float(fs.values[k - 1] - fs.values[k])
    delta = float((dl - fl).abs().max())
    return dict(gap=gap, delta=delta, near_tie=gap <= delta)


def judge_flips(fwd: dict, seen: dict, k: int, rerun) -> dict:
    """Judge one decode step's route flips one at a time in layer order.
    ``fwd`` and ``seen`` are the forward's and the step's router logits
    of sequence 0's token by layer; ``rerun(pins)`` re-runs the step with
    the layers in ``pins`` routed to the given experts and returns
    (logits, router logits by layer).  The lowest layer that flips is
    judged; a near-tie is pinned to the forward's experts and the step
    re-run, so the next flip is judged on inputs that differ from the
    forward's by rounding alone; it stops at the first flip that is not
    a near-tie or when none is left.  Returns the judged flips
    (``rounds``), the pinned layers and the last re-run's logits (None
    when nothing was pinned)."""
    import torch
    pins, rounds, logits = {}, [], None
    while True:
        flip = None
        for layer in sorted(seen):
            if layer not in pins:
                flip = route_flip(seen[layer], fwd[layer], k)
                if flip:
                    flip["layer"] = layer
                    break
        if flip is None:
            break
        rounds.append(flip)
        if not flip["near_tie"]:
            break
        pins[flip["layer"]] = torch.sort(
            fwd[flip["layer"]], descending=True, stable=True).indices[:k]
        logits, seen = rerun(pins)
    return dict(rounds=rounds, pinned=sorted(pins), logits=logits)


def decode_vs_forward(model, cfg, prompts, n_steps: int) -> dict:
    """Greedy decode of ``prompts`` (prefill + ``n_steps`` steps) against a
    fresh forward over sequence 0's prompt and generated tokens, both on
    ``cfg``.  Per step, max |Δ logit| / max |logit|; per step and MoE
    layer, a route flip where the decode sends sequence 0's token to
    other experts than the forward does, with the forward's gap between
    its k-th and (k+1)-th router logits and the largest |Δ router logit|
    between the two (a near-tie: gap ≤ Δ).  Each step with a flip is
    then re-run from the same cache and judged by ``judge_flips``
    (``judged``: the flips judged, the layers pinned, the pinned
    re-run's error, and whether a last unpinned re-run, which also puts
    the step's own row back into the cache, gave the step's logits bit
    for bit).  A re-run reads the key / value rows of earlier positions
    from the last cache (later rows are masked) and the SSM layers'
    states as they were before its step: a decode step replaces an SSM
    cache's tensors, and the ones each step starts from are kept on the
    host."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.moe import route
    from repro_torch.models.ssm import SSMCache
    s, k = prompts.shape[1], cfg.top_k
    dec, fwd, ssm_before = {}, {}, []

    def keep_ssm(i, caches):
        ssm_before.append([(c, c.conv.cpu(), c.state.cpu())
                           for g in caches for c in g.values()
                           if isinstance(c, SSMCache)])

    def on_decode(layer, mod, x):
        dec.setdefault(layer, []).append(route(mod, x[:1, -1], cfg).logits[0])

    def on_forward(layer, mod, x):
        fwd[layer] = route(mod, x[0, s:s + n_steps], cfg).logits

    hooks = moe_inputs(model, on_decode)
    with torch.no_grad():
        try:
            gen, steps, caches = greedy(api, model, cfg, prompts, n_steps,
                                        s + n_steps,
                                        after_prefill=hooks.__enter__,
                                        before_step=keep_ssm)
        finally:
            hooks.__exit__()
        seq = torch.cat([prompts[:1], gen[:1, :n_steps]], 1)
        with moe_inputs(model, on_forward):
            full = api.forward(model, {"tokens": seq}, cfg)[0]
        step_rel = [_rel_err(steps[i + 1][0], full[s + i])
                    for i in range(n_steps)]
        flips = []
        for i in range(n_steps):
            first = None        # the step's first flipped layer
            for layer in sorted(dec):
                flip = route_flip(dec[layer][i], fwd[layer][i], k)
                if flip:
                    flips.append(dict(step=i, layer=layer, after=first,
                                      **flip))
                    first = layer if first is None else first
        judged = []
        for i in sorted({f["step"] for f in flips}):
            def rerun(pins, i=i):
                for c, conv, state in ssm_before[i]:
                    c.conv = conv.to(c.conv.device)
                    c.state = state.to(c.state.device)
                return pinned_step(model, cfg, gen[:, i:i + 1], s + i,
                                   caches, pins)
            j = judge_flips({n: fwd[n][i] for n in fwd},
                            {n: dec[n][i] for n in dec}, k, rerun)
            logits = j.pop("logits")
            j.update(step=i, pinned_rel=(
                None if logits is None else _rel_err(logits[0], full[s + i])))
            j["follows"] = [f["layer"] for f in flips if f["step"] == i
                            and f["layer"] not in
                            {x["layer"] for x in j["rounds"]}]
            j["reproduces"] = bool(torch.equal(rerun({})[0], steps[i + 1]))
            judged.append(j)
        del caches, ssm_before
    agree = float((full[s - 1:].argmax(-1) == gen[0, :n_steps + 1])
                  .float().mean())
    return dict(capacity_factor=cfg.capacity_factor, batch=prompts.shape[0],
                step_rel=step_rel,
                flips=flips, judged=judged, greedy_agreement=agree,
                finite=all(bool(torch.isfinite(t).all()) for t in steps))


def routes_by_call(model, cfg, tokens, n_steps: int):
    """Greedy decode of ``tokens`` (prefill + ``n_steps`` steps) with hooks
    on the MoE modules: (generated, every step's logits, each MoE call's
    (layer, top-k, keep, slot, router logits) on the host)."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.moe import route
    calls = []

    def read(layer, mod, x):
        r = route(mod, x.reshape(-1, x.shape[-1]), cfg)
        calls.append((layer, r.topi.cpu(), r.keep.cpu(), r.slot.cpu(),
                      r.logits.cpu()))
    with torch.no_grad(), moe_inputs(model, read):
        gen, steps, _ = greedy(api, model, cfg, tokens, n_steps,
                               tokens.shape[1] + n_steps)
    return gen, steps, calls


def memory_before(name: str) -> dict:
    """Phases 13 and 16 before their model: free what earlier phases
    hold, print and return what is still allocated and reserved (more
    than MOE_START_ALLOCATED allocated fails the phase), and reset the
    card's peak."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(allocated_before=torch.cuda.memory_allocated(),
               reserved_before=torch.cuda.memory_reserved())
    print(f"{name}: before the model, "
          f"{res['allocated_before'] / 2 ** 30:.3f} GiB allocated, "
          f"{res['reserved_before'] / 2 ** 30:.3f} GiB reserved "
          f"(limit {MOE_START_ALLOCATED / 2 ** 30:.0f} GiB allocated)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    return res


def serve_moe_lm(model, cfg, prompts, decode: int, device,
                 check_batch: int | None = None) -> dict:
    """Phases 13, 16 and 19's bf16 checks of a MoE LM ``model``: (a) the
    main path, a prefill of ``prompts`` and ``decode`` greedy steps, the
    clock and the counters zeroed before each and read after; (b) one
    prefill's routing at ``cfg``'s capacity, read through forward hooks;
    on the card a warm prefill and the device profiles of one prefill and
    of 8 decode steps; (c) decode of the first ``check_batch`` prompts
    (default all) against a fresh forward at the check-only capacity
    factor E / k (capacity = T: no pair can drop in either); the peak
    memory."""
    import dataclasses

    import torch

    from repro_torch.kernels import build
    from repro_torch.models import api

    on_card = torch.device(device).type == "cuda"
    batch, prompt = prompts.shape
    cap = prompt + decode
    res = {}

    # (a) the main path: prefill, then greedy decode; the clock and the
    # counters are read after each
    marks = []

    def mark():
        _sync(device)
        marks.append((time.perf_counter(), dict(build.LAUNCHES)))
        build.reset_launches()

    build.reset_launches()
    t0 = time.perf_counter()
    gen, steps, caches = greedy(api, model, cfg, prompts, decode, cap,
                                after_prefill=mark)
    mark()
    (t1, res["prefill_launches"]), (t2, res["decode_launches"]) = marks
    res["prefill_cold_s"], decode_s = t1 - t0, t2 - t1
    res["decode_ms_per_step"] = 1e3 * decode_s / decode
    res["finite"] = all(bool(torch.isfinite(t).all()) for t in steps)
    res["generated"] = gen[0].tolist()
    del caches, steps, gen

    # (b) the routing of one prefill at the published capacity
    res["routing"] = routing_readout(model, cfg, prompts, cap)

    if on_card:
        t0 = time.perf_counter()
        _, caches = api.prefill(model, {"tokens": prompts}, cfg,
                                cache_cap=cap)
        torch.cuda.synchronize()
        res["prefill_s"] = time.perf_counter() - t0
        res["prefill_tokens_per_s"] = batch * prompt / res["prefill_s"]
        res["profile_prefill"] = profile_device(lambda: api.prefill(
            model, {"tokens": prompts}, cfg, cache_cap=cap))

        def decode8():
            t = prompts[:, -1:]
            for i in range(8):
                logits, _ = api.decode_step(model, t, prompt + i, caches,
                                            cfg)
                t = logits.argmax(-1)[:, None]
        res["profile_decode8"] = profile_device(decode8)
        del caches

    # (c) decode against a fresh forward at the check-only capacity
    check = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k)
    t0 = time.perf_counter()
    res["bf16_decode"] = decode_vs_forward(model, check,
                                           prompts[:check_batch], decode)
    res["bf16_check_s"] = time.perf_counter() - t0
    if on_card:
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


def phase_moe(cfg, seed: int, device="cuda", batch: int = LM_BATCH,
              prompt: int = LM_PROMPT, decode: int = LM_DECODE,
              check_prompt: int = CHECK_PROMPT,
              check_decode: int = DENSE_CHECK_DECODE,
              f32_layers: int = MOE_F32_LAYERS, cut: str = "") -> dict:
    """Phase 13: serve ``cfg`` (a MoE LM at full width, its depth cut to
    ``cfg.n_layers``) in bf16 from a seeded generator.  (a) the main
    path, prefill and greedy decode, counters zeroed before each and read
    after; (b) one prefill's routing at the published capacity, read
    through forward hooks; (c) decode against a fresh forward at the
    check-only capacity factor E / k (capacity = T: no pair can drop in
    either), in bf16 and, on ``f32_layers`` layers, in float32; (d) the
    float32 model on ``device`` and on the CPU at the published capacity:
    logits, greedy tokens and every MoE call's routing.  The verdict is
    ``moe_failures``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import api

    on_card = torch.device(device).type == "cuda"
    res = dict(arch=cfg.name, n_layers=cfg.n_layers, cut=cut,
               kernel="flash_attention", d_model=cfg.d_model,
               capacity_factor=cfg.capacity_factor, batch=batch,
               prompt=prompt, decode=decode)
    if on_card:
        res.update(memory_before(cfg.name))
    t0 = time.perf_counter()
    gen_w = torch.Generator(device=device).manual_seed(seed)
    model = api.init_params(cfg, gen_w, torch.bfloat16, device)
    _sync(device)
    res["init_s"] = time.perf_counter() - t0
    res["params"] = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt))).to(device)
    res.update(serve_moe_lm(model, cfg, prompts, decode, device))
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (c) in float32 and (d): f32_layers layers at full width, drawn on
    # the card and copied, so both devices start from the same bits
    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=f32_layers)
    cpu, card = f32_pair(small, seed, device)
    res["f32_decode"] = decode_vs_forward(
        card, dataclasses.replace(small, capacity_factor=small.n_experts
                                  / small.top_k), prompts, decode)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, check_prompt)))
    g_card, s_card, r_card = routes_by_call(card, small, toks.to(device),
                                            check_decode)
    g_cpu, s_cpu, r_cpu = routes_by_call(cpu, small, toks, check_decode)
    differs = [(i, a[0], name)
               for i, (a, b) in enumerate(zip(r_card, r_cpu))
               for name, x, y in zip(("topi", "keep", "slot"), a[1:], b[1:])
               if not torch.equal(x, y)]
    if len(r_card) != len(r_cpu):
        differs.append(("calls", len(r_card), len(r_cpu)))
    res["card_cpu"] = dict(
        capacity_factor=small.capacity_factor, layers=f32_layers,
        rel=max(_rel_err(a.cpu(), b) for a, b in zip(s_card, s_cpu)),
        same_tokens=bool(torch.equal(g_card.cpu(), g_cpu)),
        calls=len(r_card), route_differs=differs, prompt=check_prompt,
        decode=check_decode,
        dropped=sum(int((~c[2]).sum()) for c in r_card))
    res["f32_check_s"] = time.perf_counter() - t0
    del card, cpu
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return res


def decode_rule_failures(what: str, d: dict) -> list:
    """Phase 13's decode rules (``moe_failures``) on one
    ``decode_vs_forward`` result ``d``, ``what`` "bf16" or "float32"."""
    bad = []
    if not d["finite"]:
        bad.append(f"{what} decode check: non-finite logits")
    flipped = {f["step"] for f in d["flips"]}
    if what == "float32" and d["flips"]:
        bad.append(f"float32 decode routes differently from the "
                   f"forward at (step, layer) "
                   f"{[(f['step'], f['layer']) for f in d['flips']]}")
    rel = d["step_rel"]
    tol = ([BF16_FIRST_STEP_RTOL] + [BF16_DECODE_RTOL] * (len(rel) - 1)
           if what == "bf16" else [F32_CARD_CPU_RTOL] * len(rel))
    for j in d["judged"] if what == "bf16" else ():
        i, pinned = j["step"], j["pinned"]
        for f in j["rounds"]:
            if not f["near_tie"]:
                bad.append(
                    f"bf16 decode: the route flip at step {i}, layer "
                    f"{f['layer']} is not a near-tie (gap "
                    f"{f['gap']:.4g} > |Δ router logit| "
                    f"{f['delta']:.4g})" + (
                        f" with layers {pinned} pinned to the "
                        f"forward's experts" if pinned else ""))
        if (j["rounds"] and all(f["near_tie"] for f in j["rounds"])
                and not j["pinned_rel"] <= tol[i]):
            bad.append(f"bf16 decode with step {i}'s near-tie flips "
                       f"(layers {pinned}) pinned to the forward's "
                       f"experts disagrees with a fresh forward: rel "
                       f"err {j['pinned_rel']:.4g} (tolerance "
                       f"{tol[i]:.4g})")
        if not j["reproduces"]:
            bad.append(f"bf16 decode: a re-run of step {i} does not "
                       f"give the step's logits bit for bit")
    over = [(i, r) for i, (r, t) in enumerate(zip(rel, tol))
            if i not in flipped and not r <= t]
    if over:
        bad.append(f"{what} decode disagrees with a fresh forward at "
                   f"steps without a route flip: (step, rel err) "
                   f"{[(i, round(r, 5)) for i, r in over]}")
    return bad


def drop_failures(res: dict) -> list:
    """Phases 13 and 19's routing rule: some pair of one prefill dropped
    at the published capacity."""
    ro = res["routing"]
    if ro["dropped"]:
        return []
    return [f"no pair dropped at capacity_factor {res['capacity_factor']} "
            f"(capacity {ro['cap']}, fullest expert {ro['fullest']})"]


def moe_failures(res: dict) -> list:
    """Phase 13's verdict on ``phase_moe``'s result: every failed check,
    named; empty when the phase passed.  The decode rules: a step at
    which no MoE layer routes sequence 0's token differently from the
    forward is held to BF16_FIRST_STEP_RTOL (the first step) or
    BF16_DECODE_RTOL; in float32 no flip at all, and every step within
    F32_CARD_CPU_RTOL.  A bf16 step with a route flip is judged on its re-runs
    (``judge_flips``): every flip judged must be a near-tie (the
    forward's gap between its k-th and (k+1)-th router logits at most
    the largest |Δ router logit| of that token and layer), the re-run
    with the judged flips pinned to the forward's experts is held to the
    step's tolerance, and the unpinned re-run must give the step's
    logits bit for bit."""
    bad = []
    if res.get("allocated_before", 0) > MOE_START_ALLOCATED:
        bad.append(f"{res['allocated_before'] / 2 ** 30:.2f} GiB still "
                   f"allocated when the phase began (limit "
                   f"{MOE_START_ALLOCATED / 2 ** 30:.0f} GiB)")
    k, n = res["kernel"], res["n_layers"]
    pre = res["prefill_launches"]
    if pre.get(k, 0) != n:
        bad.append(f"a prefill launched {k} {pre.get(k, 0)} times, want {n}")
    others = {m: c for m, c in pre.items() if m != k and c}
    if others:
        bad.append(f"a prefill launched {others}")
    if any(res["decode_launches"].values()):
        bad.append(f"decode launched {res['decode_launches']}")
    if not res["finite"]:
        bad.append("non-finite logits")
    bad += drop_failures(res)
    for what, d in (("bf16", res["bf16_decode"]),
                    ("float32", res["f32_decode"])):
        bad += decode_rule_failures(what, d)
    c = res["card_cpu"]
    if not c["rel"] <= F32_CARD_CPU_RTOL:
        bad.append(f"float32 card and CPU logits differ by {c['rel']:.3g} "
                   f"(tolerance {F32_CARD_CPU_RTOL:.3g})")
    if not c["same_tokens"]:
        bad.append("float32 card and CPU greedy tokens differ")
    if c["route_differs"]:
        bad.append(f"float32 card and CPU route differently: (call, layer, "
                   f"field) {c['route_differs'][:8]}")
    return [f"{res['arch']}: {b}" for b in bad]


def routing_line(res: dict) -> str:
    ro = res["routing"]
    return (f"{res['arch']}: routing of one prefill at capacity_factor "
            f"{res['capacity_factor']}: dropped {ro['dropped_share']:.4f} "
            f"of {ro['pairs']} pairs ({ro['dropped']}; "
            f"{ro['layers_dropping']} of {len(ro['per_layer'])} layers "
            f"drop), fullest expert {ro['fullest']} pairs for capacity "
            f"{ro['cap']}")


def bf16_decode_line(res: dict) -> str:
    """``decode_vs_forward``'s bf16 result, each route flip and how its
    step was judged."""
    b = res["bf16_decode"]
    flipped = {x["step"] for x in b["flips"]}
    calm = [r for i, r in enumerate(b["step_rel"]) if i not in flipped]
    return (
        f"{res['arch']}: bf16 decode of {b['batch']} prompt(s) vs fresh "
        f"forward at the check-only "
        f"capacity_factor {b['capacity_factor']} (capacity = T, nothing "
        f"drops): rel err first step {b['step_rel'][0]:.4g} (tolerance "
        f"{BF16_FIRST_STEP_RTOL:.4g} without a flip), steps without a flip "
        f"max {max(calm) if calm else float('nan'):.4g} (tolerance "
        f"{BF16_DECODE_RTOL:.4g}), greedy agreement "
        f"{b['greedy_agreement']:.3f}; route flips {len(b['flips'])}"
        + "".join(f"; step {x['step']} layer {x['layer']}: gap "
                  f"{x['gap']:.4g}, |Δ router logit| {x['delta']:.4g}, "
                  f"near-tie {x['near_tie']}, "
                  + ("the step's first flip" if x["after"] is None
                     else f"after the flip at layer {x['after']}")
                  + f", step rel err {b['step_rel'][x['step']]:.4g}"
                  for x in b["flips"])
        + "".join(f"; step {j['step']} re-run: flips judged "
                  + ", ".join(f"layer {f['layer']} (gap {f['gap']:.4g}, "
                              f"|Δ| {f['delta']:.4g}, near-tie "
                              f"{f['near_tie']})" for f in j["rounds"])
                  + f", pinned {j['pinned']}, following from them "
                  f"{j['follows']}, rel err with them pinned "
                  + ("n/a" if j["pinned_rel"] is None
                     else f"{j['pinned_rel']:.4g}")
                  + f", unpinned re-run bit-equal {j['reproduces']}"
                  for j in b["judged"]))


def profile_lines(res: dict) -> list:
    lines = []
    for what in ("prefill", "decode8"):
        pr = res.get(f"profile_{what}")
        if pr:
            lines.append(
                f"{res['arch']} profile, "
                f"{'prefill' if what == 'prefill' else '8 decode steps'}: "
                f"wall {pr['wall_s']:.4f} s, device {pr['device_s']:.4f} s, "
                f"busy {pr['busy']:.3f}; top " + "; ".join(
                    f"{k} {ms:.2f} ms x{n}" for k, ms, n in pr["top_ms"]))
    return lines


def moe_lines(res: dict, smi: str) -> list:
    """Phase 13's printed lines, the card's name and power limit beside
    its times."""
    f, c = res["f32_decode"], res["card_cpu"]
    return [
        f"{res['arch']} [moe] on {smi}: {res['n_layers']} layers (cut: "
        f"{res['cut']}), d {res['d_model']}, {res['params'] / 1e9:.2f} B "
        f"params; prefill {res['batch']}x{res['prompt']} in "
        f"{res['prefill_s']:.4f} s ({res['prefill_tokens_per_s']:.0f} "
        f"tokens/s; cold {res['prefill_cold_s']:.4f} s), decode "
        f"{res['decode_ms_per_step']:.3f} ms/step, peak "
        f"{res['peak_gib']:.2f} GiB, init {res['init_s']:.1f} s; launches "
        f"per prefill {res['prefill_launches']}, decode "
        f"{res['decode_launches']}",
        routing_line(res), bf16_decode_line(res),
        f"{res['arch']}: float32, {c['layers']} layers at full width: decode "
        f"vs fresh forward at capacity_factor {f['capacity_factor']}: max "
        f"rel err {max(f['step_rel']):.3g} (tolerance "
        f"{F32_CARD_CPU_RTOL:.3g}), route flips {len(f['flips'])}; card vs "
        f"CPU at capacity_factor {c['capacity_factor']}, prompt "
        f"{c['prompt']} + {c['decode']} steps (DENSE_CHECK_DECODE, cut for "
        f"the script's time): rel err {c['rel']:.3g} "
        f"(tolerance {F32_CARD_CPU_RTOL:.3g}), greedy tokens identical: "
        f"{c['same_tokens']}, {c['calls']} MoE calls route alike: "
        f"{not c['route_differs']} ({c['dropped']} pairs dropped on the "
        f"card) ({res['f32_check_s']:.1f} s)"] + profile_lines(res)


# ---------------------------------------------------------------------------
# Phase 16: jamba-1.5-large, the hybrid family, one published period


HYBRID_ARCH = "jamba-1.5-large-398b"
# a prefill's activations, the SSM and KV caches and the expert
# intermediates at 8 × 2048 tokens, above the weights.  Read on an H100
# 80GB HBM3 at 700 W: with 3 MoE layers' experts (66.1 GiB of weights)
# and 10 GiB set aside a prefill ran out of memory at 78.4 GiB
# allocated; with 2 (48.09 GiB) the phase peaked 17.35 GiB above the
# weights, in (c)'s prefill at capacity_factor 8, where each expert
# holds all 16,384 tokens
HYBRID_TRANSIENT_BYTES = 18 * 2 ** 30
# fewer MoE layers with experts of their own fails the phase
HYBRID_MIN_DISTINCT = 2
# (d)'s float32 card-vs-CPU check: the published period, 16 experts
# top-2, the SSM shapes, vocabulary and capacity, at a width whose
# float32 weights (~3.3 GB) the CPU runs within the phase's time; the
# published period is ~180 GB in float32
HYBRID_CHECK_WIDTH = dict(d_model=1024, n_heads=8, n_kv_heads=1,
                          head_dim=128, d_ff=3072)


def hybrid_config():
    """jamba-1.5-large at published width, one period of layers (the
    reference runs whole periods only)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    return dataclasses.replace(cfg, n_layers=cfg.attn_period)


def hybrid_check_config(cfg):
    import dataclasses
    return dataclasses.replace(cfg, **HYBRID_CHECK_WIDTH)


def n_moe_layers(cfg) -> int:
    from repro_torch.models.blocks import layer_kinds, n_groups
    return n_groups(cfg) * sum(f == "moe" for _, f in layer_kinds(cfg))


def stored_params(cfg, distinct: int) -> tuple:
    """``cfg``'s parameters as ``hybrid_model`` stores them, expert
    weights for ``distinct`` MoE layers only (the others share them):
    (those in the weights' dtype, those kept float32 — the SSM's
    ``A_log`` / ``D`` / ``dt_bias`` and the routers).  Any LM family
    whose layers ``models.blocks.layer_kinds`` names (dense, moe, ssm,
    hybrid) with RMS norms and a gated MLP or experts."""
    from repro_torch.models.blocks import layer_kinds, n_groups
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff

    def mixer(kind):
        if kind == "attn":
            return 2 * d * cfg.hd() * (cfg.n_heads + cfg.n_kv_heads), 0
        d_in, n, nh = cfg.d_inner(), cfg.ssm_state, cfg.ssm_nheads()
        return (d * (2 * d_in + 2 * n + nh) + cfg.ssm_conv * (d_in + 2 * n)
                + d_in + d_in * d), 3 * nh
    ffn = {"mlp": (3 * d * f, 0), "moe": (0, d * e)}
    low = f32 = 0
    for m, k in layer_kinds(cfg):
        a, b = mixer(m)
        low += 2 * d + a + ffn[k][0]
        f32 += b + ffn[k][1]
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return (n_groups(cfg) * low + embed + d + distinct * 3 * e * d * f,
            n_groups(cfg) * f32)


def hybrid_weight_bytes(cfg, distinct: int) -> int:
    """Bytes of ``cfg``'s weights as phases 16 and 19 store them
    (``stored_params``): bf16, the float32 ones in float32."""
    low, f32 = stored_params(cfg, distinct)
    return 2 * low + 4 * f32


def hybrid_distinct_moe(cfg, free_bytes: int, override: int = 0,
                        transient: int = HYBRID_TRANSIENT_BYTES) -> tuple:
    """Phases 16 and 19's count of MoE layers with expert weights of their
    own, and the reason, as printed: ``override`` (``--hybrid-distinct``)
    if given, else every MoE layer of ``cfg``, one fewer while the
    weights and ``transient`` exceed ``free_bytes``.  The MoE layers past
    the count serve the last distinct layer's experts."""
    total = n_moe_layers(cfg)
    if override:
        return override, (f"{override} of {total} MoE layers with experts "
                          f"of their own (--hybrid-distinct)")
    n = total
    while n > 1 and hybrid_weight_bytes(cfg, n) + transient > free_bytes:
        n -= 1
    why = (f"{n} of {total} MoE layers with experts of their own: the "
           f"weights are {hybrid_weight_bytes(cfg, total) / 1e9:.1f} GB "
           f"with all {total}, {hybrid_weight_bytes(cfg, n) / 1e9:.1f} GB "
           f"with {n}, with {transient / 2 ** 30:.0f} GiB for "
           f"activations, of {free_bytes / 2 ** 30:.1f} GiB free")
    if n < total:
        why += (f"; MoE layers {n + 1}..{total} route over MoE layer {n}'s "
                f"{cfg.n_experts} experts")
    return n, why


def shared_experts_init(distinct: int):
    """An ``init_moe`` for ``models.blocks``: the first ``distinct`` MoE
    layers it builds draw their experts one at a time (a float32 draw of
    a whole [E, d, f] tensor would need ~26 GB beside the weights at
    jamba's width); every later one draws its own router and takes the
    last distinct layer's ``w_up`` / ``w_gate`` / ``w_down`` Parameters
    themselves, so nothing larger than what is kept is allocated."""
    import torch

    from repro_torch.models.layers import _normal, params_module
    from repro_torch.models.moe import MoE
    made = []

    def init_moe(gen, cfg, dtype, device):
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        mod = params_module(MoE(), wg=_normal(gen, (d, e), d ** -0.5,
                                              torch.float32, device))
        names = (("w_up", (d, f), d ** -0.5), ("w_down", (f, d), f ** -0.5))
        if cfg.mlp_kind in ("swiglu", "geglu"):
            names += (("w_gate", (d, f), d ** -0.5),)
        for name, shape, scale in names:
            if len(made) < distinct:
                w = torch.empty((e, *shape), dtype=dtype, device=device)
                for i in range(e):
                    w[i] = _normal(gen, shape, scale, dtype, device)
                mod.register_parameter(name, torch.nn.Parameter(w))
            else:
                setattr(mod, name, getattr(made[distinct - 1], name))
        made.append(mod)
        return mod
    return init_moe


def hybrid_model(cfg, seed: int, distinct: int, dtype, device):
    """``cfg``'s LM from a seeded generator on ``device``, its MoE layers
    past the first ``distinct`` sharing that layer's experts
    (``shared_experts_init``, in place of ``models.blocks.init_moe`` for
    the build)."""
    import torch

    from repro_torch.models import api, blocks
    real = blocks.init_moe
    blocks.init_moe = shared_experts_init(distinct)
    try:
        return api.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(seed), dtype, device)
    finally:
        blocks.init_moe = real


def expert_sharing(model) -> dict:
    """Parameters as served (each MoE layer counting its experts) and as
    stored, and each MoE layer whose experts are another's."""
    from repro_torch.models.moe import MoE
    owner, shares = {}, {}
    for name, m in model.named_modules():
        if isinstance(m, MoE):
            first = owner.setdefault(id(m.w_up), name)
            if first != name:
                shares[name] = first
    return dict(served=sum(p.numel() for _, p in model.named_parameters(
                    remove_duplicate=False)),
                stored=sum(p.numel() for p in model.parameters()),
                stored_bytes=sum(p.numel() * p.element_size()
                                 for p in model.parameters()),
                shares=shares)


def hybrid_launches_want(cfg) -> dict:
    """Each kernel's launches in one prefill: B5 once an attention layer,
    B6 once an SSM layer."""
    from repro_torch.models.blocks import layer_kinds, n_groups
    kinds = [m for m, _ in layer_kinds(cfg)] * n_groups(cfg)
    return {"flash_attention": kinds.count("attn"),
            "ssd_scan": kinds.count("ssm")}


def route_differences(card_calls, cpu_calls, k: int) -> dict:
    """``routes_by_call``'s calls on the card against the CPU's: every
    token whose top-k differs, judged by ``route_flip`` (the CPU in the
    forward's place; the same experts in another order: the gap between
    the first pair of the CPU's top-k that swaps), and the calls whose
    keep mask or slots differ with no token routed differently."""
    import torch
    flips, unexplained = [], []
    if len(card_calls) != len(cpu_calls):
        unexplained.append(("calls", len(card_calls), len(cpu_calls)))
    for i, (a, b) in enumerate(zip(card_calls, cpu_calls)):
        rows = (a[1] != b[1]).any(-1).nonzero().flatten().tolist()
        for t in rows:
            f = route_flip(a[4][t], b[4][t], k)
            if f is None:
                fs = torch.sort(b[4][t], descending=True, stable=True)
                j = int((a[1][t] != b[1][t]).nonzero()[0])
                gap = float(fs.values[j] - fs.values[j + 1])
                delta = float((a[4][t] - b[4][t]).abs().max())
                f = dict(gap=gap, delta=delta, near_tie=gap <= delta)
            flips.append(dict(call=i, layer=a[0], token=t, **f))
        if not rows and not (torch.equal(a[2], b[2])
                             and torch.equal(a[3], b[3])):
            unexplained.append((i, a[0]))
    return dict(flips=flips, unexplained=unexplained)


def phase_hybrid(cfg, seed: int, distinct: int, device="cuda",
                 batch: int = LM_BATCH, prompt: int = LM_PROMPT,
                 decode: int = LM_DECODE, check_cfg=None,
                 check_prompt: int = CHECK_PROMPT,
                 check_decode: int = DENSE_CHECK_DECODE,
                 check_batch: int | None = None, cut: str = "") -> dict:
    """Phase 16 (and 19's body): serve ``cfg`` (a hybrid or MoE LM at
    full width) in bf16 from a seeded generator, ``distinct`` of its MoE
    layers with experts of their own (``hybrid_model``).  (a) the main
    path, prefill and greedy decode, counters zeroed before each and read
    after; (b) one prefill's routing at the published capacity; (c) bf16
    decode of the first ``check_batch`` prompts against a fresh forward
    at the check-only capacity factor E / k; (d) ``check_cfg`` (default
    ``hybrid_check_config``) in float32 on ``device`` and on the CPU at
    the published capacity over ``check_decode`` steps: logits, greedy
    tokens and every MoE call's routing.  The verdict is
    ``hybrid_failures``."""
    import numpy as np
    import torch

    on_card = torch.device(device).type == "cuda"
    res = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
               d_model=cfg.d_model, n_experts=cfg.n_experts,
               moe_layers=n_moe_layers(cfg), distinct=distinct, cut=cut,
               capacity_factor=cfg.capacity_factor, batch=batch,
               prompt=prompt, decode=decode,
               want=hybrid_launches_want(cfg))
    if on_card:
        res.update(memory_before(cfg.name))
    t0 = time.perf_counter()
    model = hybrid_model(cfg, seed, distinct, torch.bfloat16, device)
    _sync(device)
    res["init_s"] = time.perf_counter() - t0
    res.update(expert_sharing(model))
    if on_card:
        res["weights_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt))).to(device)
    res.update(serve_moe_lm(model, cfg, prompts, decode, device,
                            check_batch))
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (d) float32 on the card against the CPU, drawn on the card and
    # copied, so both devices start from the same bits
    small = check_cfg or hybrid_check_config(cfg)
    t0 = time.perf_counter()
    cpu, card = f32_pair(small, seed, device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, check_prompt)))
    g_card, s_card, r_card = routes_by_call(card, small, toks.to(device),
                                            check_decode)
    g_cpu, s_cpu, r_cpu = routes_by_call(cpu, small, toks, check_decode)
    res["card_cpu"] = dict(
        width={k: getattr(small, k) for k in HYBRID_CHECK_WIDTH},
        layers=small.n_layers, capacity_factor=small.capacity_factor,
        gb=sum(p.numel() * p.element_size() for p in cpu.parameters()) / 1e9,
        rel=max(_rel_err(a.cpu(), b) for a, b in zip(s_card, s_cpu)),
        same_tokens=bool(torch.equal(g_card.cpu(), g_cpu)),
        calls=len(r_card), prompt=check_prompt, decode=check_decode,
        dropped=sum(int((~c[2]).sum()) for c in r_card),
        **route_differences(r_card, r_cpu, small.top_k))
    res["f32_check_s"] = time.perf_counter() - t0
    del card, cpu
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return res


def served_moe_failures(res: dict) -> list:
    """The checks phases 16 and 19 share on ``phase_hybrid``'s result,
    each failed one named: more than MOE_START_ALLOCATED allocated when
    the phase began; a prefill launching other than ``want`` says, or
    any kernel in decode; non-finite logits; the bf16 decode rules of
    phase 13 (``decode_rule_failures``); float32 card and CPU logits
    beyond F32_CARD_CPU_RTOL, other greedy tokens, or a token routed
    differently that is not a near-tie (or a keep mask or slots that
    differ with every token routed alike)."""
    bad = []
    if res.get("allocated_before", 0) > MOE_START_ALLOCATED:
        bad.append(f"{res['allocated_before'] / 2 ** 30:.2f} GiB still "
                   f"allocated when the phase began (limit "
                   f"{MOE_START_ALLOCATED / 2 ** 30:.0f} GiB)")
    pre = res["prefill_launches"]
    for k, n in res["want"].items():
        if pre.get(k, 0) != n:
            bad.append(f"a prefill launched {k} {pre.get(k, 0)} times, "
                       f"want {n}")
    others = {m: c for m, c in pre.items() if m not in res["want"] and c}
    if others:
        bad.append(f"a prefill launched {others}")
    if any(res["decode_launches"].values()):
        bad.append(f"decode launched {res['decode_launches']}")
    if not res["finite"]:
        bad.append("non-finite logits")
    bad += decode_rule_failures("bf16", res["bf16_decode"])
    c = res["card_cpu"]
    if not c["rel"] <= F32_CARD_CPU_RTOL:
        bad.append(f"float32 card and CPU logits differ by {c['rel']:.3g} "
                   f"(tolerance {F32_CARD_CPU_RTOL:.3g})")
    if not c["same_tokens"]:
        bad.append("float32 card and CPU greedy tokens differ")
    far = [(f["call"], f["layer"], f["token"]) for f in c["flips"]
           if not f["near_tie"]]
    if far:
        bad.append(f"float32 card and CPU route tokens differently with no "
                   f"near-tie: (call, layer, token) {far[:8]}")
    if c["unexplained"]:
        bad.append(f"float32 card and CPU keep or slot pairs differently "
                   f"with every token routed alike: {c['unexplained'][:8]}")
    return bad


def hybrid_failures(res: dict) -> list:
    """Phase 16's verdict on ``phase_hybrid``'s result: every failed
    check, named; empty when the phase passed.  ``served_moe_failures``,
    and fewer than HYBRID_MIN_DISTINCT MoE layers with experts of their
    own."""
    bad = served_moe_failures(res)
    if res["distinct"] < HYBRID_MIN_DISTINCT:
        bad.append(f"{res['distinct']} of {res['moe_layers']} MoE layers "
                   f"with experts of their own, fewer than "
                   f"{HYBRID_MIN_DISTINCT}")
    return [f"{res['arch']}: {b}" for b in bad]


def hybrid_lines(res: dict, smi: str) -> list:
    """Phases 16 and 19's printed lines, the card's name and power limit
    beside their times."""
    c = res["card_cpu"]
    shares = ", ".join(f"{k} uses {v}'s" for k, v in res["shares"].items())
    return [
        f"{res['arch']} [{res['family']}] on {smi}: {res['n_layers']} layers"
        + (" (one period)" if res["family"] == "hybrid" else "")
        + f", d {res['d_model']}, {res['n_experts']} experts in each "
        f"of {res['moe_layers']} MoE layers; {res['served'] / 1e9:.2f} B "
        f"params served, {res['stored'] / 1e9:.2f} B stored "
        f"({res['stored_bytes'] / 1e9:.1f} GB; experts shared: "
        f"{shares or 'none'}); {res['cut']}",
        f"{res['arch']}: prefill {res['batch']}x{res['prompt']} in "
        f"{res['prefill_s']:.4f} s ({res['prefill_tokens_per_s']:.0f} "
        f"tokens/s; cold {res['prefill_cold_s']:.4f} s), decode "
        f"{res['decode_ms_per_step']:.3f} ms/step, peak "
        f"{res['peak_gib']:.2f} GiB (weights {res['weights_gib']:.2f} GiB), "
        f"init {res['init_s']:.1f} s; launches per prefill "
        f"{res['prefill_launches']} (want {res['want']}), decode "
        f"{res['decode_launches']}",
        routing_line(res), bf16_decode_line(res),
        f"{res['arch']}: float32 check at {c['width']}, {c['layers']} "
        f"layers ({c['gb']:.2f} GB a side), card vs CPU at capacity_factor "
        f"{c['capacity_factor']}, prompt {c['prompt']} + {c['decode']} "
        f"steps (DENSE_CHECK_DECODE, cut for the script's time): rel err "
        f"{c['rel']:.3g} (tolerance "
        f"{F32_CARD_CPU_RTOL:.3g}), greedy tokens identical: "
        f"{c['same_tokens']}, {c['calls']} MoE calls, tokens routed "
        f"differently {len(c['flips'])}"
        + "".join(f" (call {f['call']} layer {f['layer']} token "
                  f"{f['token']}: gap {f['gap']:.4g}, |Δ| {f['delta']:.4g}, "
                  f"near-tie {f['near_tie']})" for f in c["flips"][:8])
        + f", {c['dropped']} pairs dropped on the card "
        f"({res['f32_check_s']:.1f} s)"] + profile_lines(res)


# ---------------------------------------------------------------------------
# Phase 19: kimi-k2-1t-a32b, the MoE family at 384 experts, served on the card


KIMI_ARCH = "kimi-k2-1t-a32b"
# the served depth's cap, for the script's time: the card holds one layer
# with experts of its own (33.8 GB of bf16 experts; with the untied
# 163,840-row tables 38.76 GB) and 15-28 more that route over its
# experts (0.242 GB each: attention, norms, router), but each adds ~12 s
# of host work to the phase: at 4 layers it took 55.8 s on one H100
# 80GB HBM3 at 700 W (a fast host), a decode step 336.8 ms (5,712 device
# kernels a layer, the experts one at a time), (c) 20.1 s; at 2 layers
# 42.5 s within the whole script
KIMI_LAYERS = 2
# beside the weights and the largest MoE call's transient
# (``moe_call_bytes``): the KV caches, activations and logits of the
# prefill and of (c)'s forward
KIMI_OTHER_BYTES = 4 * 2 ** 30
# (d)'s float32 card-vs-CPU check: published but for the width and depth
# (384 experts top-8 of d_ff 2048, 8 / 1 heads of 112 — the published
# 8:1 grouping — the vocabulary, capacity 1.25), one layer at the widest
# d_model, in steps of KIMI_CHECK_D_STEP, whose CPU decode step reads at
# most DENSE_CHECK_STEP_BYTES (``f32_step_bytes``: every expert runs);
# the published layer is ~77 GB in float32
KIMI_CHECK_HEADS = dict(n_heads=8, n_kv_heads=1)
KIMI_CHECK_D_STEP = 128


def moe_call_bytes(cfg, tokens: int) -> int:
    """The largest transient of one MoE call over ``tokens`` tokens at
    ``cfg``'s capacity, bf16: ``models.moe.experts`` holds the dispatch
    buffer [E·cap + 1, d], the experts' outputs and their concatenation
    (as large) at once."""
    from repro_torch.models.moe import capacity
    return 3 * 2 * (cfg.n_experts * capacity(cfg, tokens) + 1) * cfg.d_model


def kimi_transient_bytes(cfg) -> int:
    """Phase 19's memory beside the weights: the larger MoE call of the
    main path's prefill (LM_BATCH × LM_PROMPT tokens at the published
    capacity) and of (c)'s forward over sequence 0 (LM_PROMPT + LM_DECODE
    tokens at the check-only capacity factor E / k, capacity = T), and
    KIMI_OTHER_BYTES."""
    import dataclasses
    check = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k)
    return max(moe_call_bytes(cfg, LM_BATCH * LM_PROMPT),
               moe_call_bytes(check, LM_PROMPT + LM_DECODE)
               ) + KIMI_OTHER_BYTES


def kimi_depth(cfg, free_bytes: int, override: int = 0) -> tuple:
    """Phase 19's (distinct, layers, reckoning as printed) for ``cfg`` at
    published width: the MoE layers with experts of their own as
    ``hybrid_distinct_moe`` reckons them (weights and
    ``kimi_transient_bytes`` within ``free_bytes``) over KIMI_LAYERS
    layers, then the most layers, at most KIMI_LAYERS, whose weights with
    that many distinct fit beside the transient; ``override``
    (``--lm-layers``) sets the layers."""
    import dataclasses
    transient = kimi_transient_bytes(cfg)
    top = override or KIMI_LAYERS
    distinct, why = hybrid_distinct_moe(
        dataclasses.replace(cfg, n_layers=top), free_bytes,
        transient=transient)

    def need(n):
        return hybrid_weight_bytes(dataclasses.replace(cfg, n_layers=n),
                                   distinct) + transient
    fits = distinct
    while fits < cfg.n_layers and need(fits + 1) <= free_bytes:
        fits += 1
    layers = override or min(KIMI_LAYERS, fits)
    shared = need(distinct + 1) - need(distinct)
    why += (f"; a layer routing over another's experts is {shared / 1e9:.3f}"
            f" GB, so the card holds {fits} of {cfg.n_layers} layers; "
            + (f"{layers} (--lm-layers)" if override else
               f"{layers} served (KIMI_LAYERS, cut for the script's time)")
            + f"; the transient: the largest MoE call "
            f"{(transient - KIMI_OTHER_BYTES) / 1e9:.2f} GB (3 x the "
            f"dispatch buffer, (c)'s forward of {LM_PROMPT + LM_DECODE} "
            f"tokens at capacity_factor {cfg.n_experts // cfg.top_k}) + "
            f"{KIMI_OTHER_BYTES / 2 ** 30:.0f} GiB")
    return distinct, layers, why


def kimi_check_config(cfg):
    """(d)'s float32 config: one layer at the widest d_model (a multiple
    of KIMI_CHECK_D_STEP, at most the published) whose CPU decode step
    reads at most DENSE_CHECK_STEP_BYTES, KIMI_CHECK_HEADS of the
    published head_dim, everything else published."""
    import dataclasses
    small = dataclasses.replace(cfg, n_layers=1, head_dim=cfg.hd(),
                                **KIMI_CHECK_HEADS)
    d = cfg.d_model // KIMI_CHECK_D_STEP * KIMI_CHECK_D_STEP
    while d > KIMI_CHECK_D_STEP and f32_step_bytes(dataclasses.replace(
            small, d_model=d), 1) > DENSE_CHECK_STEP_BYTES:
        d -= KIMI_CHECK_D_STEP
    return dataclasses.replace(small, d_model=d)


def phase_kimi(cfg, seed: int, distinct: int, device="cuda",
               batch: int = LM_BATCH, prompt: int = LM_PROMPT,
               decode: int = LM_DECODE, check_cfg=None,
               check_prompt: int = CHECK_PROMPT,
               check_decode: int = DENSE_CHECK_DECODE,
               cut: str = "") -> dict:
    """Phase 19: ``phase_hybrid`` on kimi-k2 (``cfg``: published width,
    its depth cut), ``distinct`` layer(s) with experts of their own and
    the rest routing over the last one's; (c) on sequence 0 alone (at
    capacity = T a batch of 8 prompts would need a 90 GB dispatch
    buffer); (d) at ``check_cfg`` (default ``kimi_check_config``).  The
    card's memory allocated is read before and after.  The verdict is
    ``kimi_failures``."""
    before = allocated_now(device)
    res = phase_hybrid(cfg, seed, distinct, device=device, batch=batch,
                       prompt=prompt, decode=decode,
                       check_cfg=check_cfg or kimi_check_config(cfg),
                       check_prompt=check_prompt, check_decode=check_decode,
                       check_batch=1, cut=cut)
    res.update(allocated_before=res.get("allocated_before", before),
               allocated_after=allocated_now(device))
    return res


def kimi_failures(res: dict) -> list:
    """Phase 19's verdict on ``phase_kimi``'s result: every failed check,
    named; empty when the phase passed.  ``served_moe_failures`` (phase
    13's checks, with phase 16 (d)'s near-tie rule for the float32 card
    against the CPU), no pair dropped at the published capacity, and
    more of the card's memory allocated after the model than before."""
    bad = served_moe_failures(res) + drop_failures(res)
    grew = res["allocated_after"] - res["allocated_before"]
    if grew > 0:
        bad.append(f"{grew} B more allocated after the model than before it")
    return [f"{res['arch']}: {b}" for b in bad]


def kimi_lines(res: dict, smi: str) -> list:
    """Phase 19's printed lines: ``hybrid_lines``, then the decode step's
    host cost and the memory around the model."""
    lines = hybrid_lines(res, smi)
    pr = res.get("profile_decode8")
    if pr:
        per_step = pr["kernels"] / 8
        lines.append(
            f"{res['arch']}: a decode step of {res['batch']} tokens runs "
            f"{per_step:.0f} device kernels ({per_step / res['n_layers']:.0f}"
            f" a layer), {1e3 * pr['wall_s'] / 8:.3f} ms under the profiler"
            f", device busy {pr['busy']:.3f}: the host's share "
            f"{1 - pr['busy']:.3f}")
    lines.append(f"{res['arch']}: allocated before the model "
                 f"{res['allocated_before']} B, after {res['allocated_after']}"
                 f" B")
    return lines


# ---------------------------------------------------------------------------
# Phase 11: training on the card


def train_configs(cfg, batch: int, seq: int, steps: int, param_dtype=None):
    """The TrainConfig and ShardingConfig phase 11 trains ``cfg`` with:
    the defaults (AdamW in float32, ``remat="block"``), warmup 1, bf16
    params for the dense family and float32 for the SSM family (as
    ``repro.launch.train.main`` sets them), unless ``param_dtype``."""
    from repro_torch.config import ShardingConfig, TrainConfig
    dtype = param_dtype or ("bfloat16" if cfg.family == "dense"
                            else "float32")
    return TrainConfig(global_batch=batch, seq_len=seq, total_steps=steps,
                       warmup_steps=1, param_dtype=dtype), ShardingConfig()


def attention_calls(cfg, seq: int) -> list[dict]:
    """Flash attention's calls in one training forward at ``seq`` tokens,
    one dict a shape with its count: every attention layer of a decoder
    (a vlm's over its patches and tokens); an encoder-decoder's encoder
    (full), decoder self (causal) and cross-attention (full, ``seq``
    against the frames).  ``f32``: the call runs in float32 whatever the
    params, as JAX promotes float32 frames (encoder and cross)."""
    hd, hq, hkv = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    if cfg.family == "encdec":
        e = cfg.enc_seq
        return [dict(count=cfg.n_enc_layers, hq=hq, hkv=hkv, sq=e, skv=e,
                     d=hd, causal=False, window=None, f32=True),
                dict(count=cfg.n_layers, hq=hq, hkv=hkv, sq=seq, skv=seq,
                     d=hd, causal=True, window=cfg.window, f32=False),
                dict(count=cfg.n_layers, hq=hq, hkv=hkv, sq=seq, skv=e,
                     d=hd, causal=False, window=None, f32=True)]
    s = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    return [dict(count=cfg.n_layers, hq=hq, hkv=hkv, sq=s, skv=s, d=hd,
                 causal=True, window=cfg.window, f32=False)]


def launches_per_step(cfg, scfg) -> int:
    """A training step's launches of the model's kernel: one a call in
    the forward (the SSM: one a layer; attention: ``attention_calls``),
    and one more a call where ``remat`` recomputes each group or layer in
    the backward (the backward itself is the plain version)."""
    calls = (cfg.n_layers if cfg.family == "ssm"
             else sum(c["count"] for c in attention_calls(cfg, 1)))
    return calls * (1 if scfg.remat == "none" else 2)


def step_split(cfg, tcfg, scfg, state, batch) -> dict:
    """One more training step from ``state``, cut into its forward (the
    loss), backward (the gradients, the groups' recompute included) and
    optimizer update, each run under ``torch.profiler``
    (``profile_device``): the device time of each part's kernels."""
    import torch

    from repro_torch.models import api
    from repro_torch.optim import adamw_update, lr_schedule
    names, ps = zip(*state.params.named_parameters())
    held = {}

    def forward():
        held["loss"] = api.loss_fn(state.params, batch, cfg,
                                   remat=scfg.remat)

    def backward():
        held["grads"] = dict(zip(names, torch.autograd.grad(held["loss"],
                                                            ps)))

    def optimizer():
        adamw_update(held["grads"], state.opt, state.params, tcfg,
                     lr_schedule(state.step + 1, tcfg))

    return {part: profile_device(fn) for part, fn in (
        ("forward", forward), ("backward", backward),
        ("optimizer", optimizer))}


def plain_backward_ms(cfg, batch: int, seq: int, seed: int,
                      param_dtype: str = "bfloat16") -> float:
    """Card ms of the backward of one training step's kernel calls —
    what the kernel's ``autograd.Function`` runs: the plain version
    again, under autograd (CUDA events), once a shape
    (``attention_calls``) times its count; the SSM: one layer's call
    times the layers."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ssd_chunked
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype).requires_grad_()
    if cfg.family != "ssm":
        total = 0.0
        for c in attention_calls(cfg, seq):
            dt = (torch.float32 if c["f32"] or param_dtype == "float32"
                  else torch.bfloat16)
            q = randn(batch, c["hq"], c["sq"], c["d"], dtype=dt)
            k, v = (randn(batch, c["hkv"], c["skv"], c["d"], dtype=dt)
                    for _ in range(2))

            def run():
                out = attention_ref(q, k, v, causal=c["causal"],
                                    window=c["window"], scale=c["d"] ** -0.5)
                torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
            total += c["count"] * cuda_ms(run, 3)[0]
            del q, k, v
            torch.cuda.empty_cache()
        return total
    h, p, n = cfg.ssm_nheads(), cfg.ssm_headdim, cfg.ssm_state
    x, b, c = (randn(batch, seq, h, p), randn(batch, seq, n),
               randn(batch, seq, n))
    dt = (torch.nn.functional.softplus(randn(batch, seq, h)) * 0.1
          ).detach().requires_grad_()
    a = (-torch.linspace(1.0, 16.0, h, device="cuda")).requires_grad_()
    ins = (x, dt, a, b, c)

    def run():
        y, st = ssd_chunked(*ins, cfg.ssm_chunk)
        torch.autograd.grad((y, st), ins, (torch.ones_like(y),
                                           torch.ones_like(st)))
    return cfg.n_layers * cuda_ms(run, 3)[0]


class counting:
    """Counts the calls of ``module.<name>`` inside the block (the
    module's own calls by that global name included)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_train(cfg, kernel: str, seed: int, device="cuda",
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                steps: int = TRAIN_STEPS, param_dtype=None) -> dict:
    """Phase 11 (a) / (b) and 15 (a): train ``cfg`` through
    ``repro_torch.launch.train.train`` for ``steps`` steps.  First the
    first step's gradients (``make_grad_fn`` on the same initial state
    and batch), every parameter's read; then the main path, counters
    zeroed just before it and read just after — with the calls of the
    plain attention forward (``attention._sdpa``, decode's) and of the
    plain version B5's backward runs (``attention_ref``) counted; on
    the card also one step's device split and the plain backward's
    share.  The verdict is ``train_failures``."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.train import train
    from repro_torch.models import attention
    from repro_torch.runtime import init_train_state, make_grad_fn

    tcfg, scfg = train_configs(cfg, batch, seq, steps, param_dtype)
    on_card = torch.device(device).type == "cuda"
    res = dict(arch=cfg.name, n_layers=cfg.n_layers, kernel=kernel,
               batch=batch, seq=seq, steps=steps,
               param_dtype=tcfg.param_dtype, remat=scfg.remat,
               per_step=launches_per_step(cfg, scfg))
    state = init_train_state(cfg, tcfg, device=device)
    batch0 = SyntheticLM(cfg, batch, seq, seed=tcfg.seed,
                         device=device).batch_at(0)
    build.reset_launches()
    _, grads = make_grad_fn(cfg, tcfg, scfg)(state.params, batch0)
    _sync(device)
    res["grad_launches"] = dict(build.LAUNCHES)
    res["bad_grads"] = [n for n, g in grads.items()
                        if not (bool(torch.isfinite(g).all())
                                and float(g.abs().max()) > 0)]
    res["n_params"] = len(grads)
    del grads, state

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    with counting(attention, "_sdpa") as fwd, \
            counting(flash_ops, "attention_ref") as bwd:
        state, hist, _ = train(cfg, tcfg, scfg, device=device, log_every=1)
        _sync(device)
    res["train_s"] = time.perf_counter() - t0
    res["launches"] = dict(build.LAUNCHES)
    if kernel == "flash_attention":
        res["plain_forward"], res["plain_backward_calls"] = \
            fwd.calls, bwd.calls
    res["loss"] = hist.rows["loss"]
    res["grad_norm"] = hist.rows["grad_norm"]
    res["step_s"] = [ms / 1e3 for ms in hist.rows["step_ms"]]
    if on_card:
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["split"] = uncounted(lambda: step_split(
            cfg, tcfg, scfg, state, batch0))
        del state
        torch.cuda.empty_cache()
        res["plain_backward_ms"] = uncounted(
            lambda: plain_backward_ms(cfg, batch, seq, seed,
                                      tcfg.param_dtype))
        warm = sorted(res["step_s"][1:]) or res["step_s"]
        res["plain_backward_share"] = (res["plain_backward_ms"] / 1e3
                                       / warm[len(warm) // 2])
    return res


def warm_median(step_s: list) -> float:
    warm = sorted(step_s[1:]) or step_s
    return warm[len(warm) // 2]


def train_lines(r: dict, smi: str = "") -> list:
    """A training run's printed lines (phases 11 (a) / (b), 15 (a)): its
    step seconds, device split, peak memory, launches, loss and grad
    norm, the plain backward's share, and the profile of each part."""
    k, sp = r["kernel"], r["split"]
    tokens = r["batch"] * r["seq"]
    lines = [
        f"train {r['arch']}: {r['n_layers']} layers, {r['param_dtype']} "
        f"params, remat {r['remat']}, {r['batch']}x{r['seq']} tokens a "
        f"step; step s " + ", ".join(f"{x:.4f}" for x in r["step_s"])
        + f" (warm median {warm_median(r['step_s']):.4f}, "
        f"{tokens / warm_median(r['step_s']):.0f} tokens/s); "
        f"device s a step: forward {sp['forward']['device_s']:.4f}, "
        f"backward {sp['backward']['device_s']:.4f}, optimizer "
        f"{sp['optimizer']['device_s']:.4f}; peak {r['peak_gib']:.2f} GiB; "
        f"{k} launches: first step {r['grad_launches'].get(k, 0)}, "
        f"{r['steps']} steps {r['launches'].get(k, 0)} (want "
        f"{r['per_step']} a step); loss "
        + ", ".join(f"{x:.4f}" for x in r["loss"]) + "; grad norm "
        + ", ".join(f"{x:.4g}" for x in r["grad_norm"])
        + f"; plain backward of a step's {k} calls "
        f"{r['plain_backward_ms']:.3f} ms = "
        f"{r['plain_backward_share']:.3f} of a warm step"
        + (f"; plain forward calls {r['plain_forward']}, plain backward "
           f"calls {r['plain_backward_calls']}" if "plain_forward" in r
           else "") + (f"  [{smi}]" if smi else "")]
    for part, pr in sp.items():
        lines.append(
            f"train {r['arch']} profile, {part}: wall {pr['wall_s']:.4f} s, "
            f"device {pr['device_s']:.4f} s, busy {pr['busy']:.3f}; top "
            + "; ".join(f"{n} {ms:.2f} ms x{c}" for n, ms, c in
                        pr["top_ms"]))
    return lines


def train_failures(res: dict) -> list:
    """Phase 11 (a) / (b)'s verdict on ``phase_train``'s result: every
    failed check, named; empty when the phase passed."""
    bad = []
    k, per = res["kernel"], res["per_step"]
    if res["bad_grads"]:
        bad.append(f"no finite nonzero gradient on the first step for "
                   f"{res['bad_grads']}")
    for what, got, want in (("the first step", res["grad_launches"], per),
                            (f"{res['steps']} steps", res["launches"],
                             per * res["steps"])):
        if got.get(k, 0) != want:
            bad.append(f"{what} launched {k} {got.get(k, 0)} times, want "
                       f"{want}")
        others = {n: c for n, c in got.items() if n != k and c}
        if others:
            bad.append(f"{what} launched {others}")
    if not all(math.isfinite(x) for x in res["loss"] + res["grad_norm"]):
        bad.append(f"non-finite loss {res['loss']} or grad norm "
                   f"{res['grad_norm']}")
    if len(res["loss"]) != res["steps"]:
        bad.append(f"{len(res['loss'])} steps logged of {res['steps']}")
    if res.get("plain_forward"):
        bad.append(f"the plain attention forward ran {res['plain_forward']} "
                   "times")
    # one plain backward a forward call: B5's autograd.Function
    calls = res["steps"] * per // (2 if res.get("remat") != "none" else 1)
    if "plain_backward_calls" in res and \
            res["plain_backward_calls"] != calls:
        bad.append(f"the plain version ran {res['plain_backward_calls']} "
                   f"times, want {calls} (one a forward call's backward)")
    return bad


def differing_arrays(a: dict, b: dict) -> list:
    """The names whose arrays differ (bytes, dtype or shape) between two
    ``checkpoint.io.raw_arrays`` dicts, or that only one holds."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or a[k].shape != b[k].shape
                  or not same_bytes(a[k], b[k]))


def same_bytes(x, y) -> bool:
    """Whether two arrays of one dtype and shape hold the same bytes,
    compared as integers of their item size in place (no copy: a
    mixtral layer's state is 6.8 GB a side)."""
    import numpy as np
    import torch

    def bits(a):
        a = np.ascontiguousarray(a).reshape(-1)
        return torch.from_numpy(a.view(f"i{a.itemsize}")
                                if a.itemsize in (1, 2, 4, 8)
                                else a.view(np.uint8))
    return torch.equal(bits(x), bits(y))


def recording_store(cls):
    """``cls`` (a ``DeltaCheckpointStore``) that keeps a host copy of the
    state of its latest ``save`` and reads each ``restore``'s result
    against it: the delta chain's guarantee, read where recovery uses
    it.  Save and restore seconds are kept."""
    from repro_torch.checkpoint import io

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.saved, self.save_s, self.restores = None, [], []

        def save(self, step, state):
            t0 = time.perf_counter()
            super().save(step, state)
            self.save_s.append(time.perf_counter() - t0)
            self.saved = (step, io.raw_arrays(state))

        def restore(self, step, template, method="ops"):
            t0 = time.perf_counter()
            out = super().restore(step, template, method)
            _sync(next(out.params.parameters()).device)
            seconds = time.perf_counter() - t0
            saved_step, want = self.saved
            self.restores.append(dict(
                step=step, saved_step=saved_step, seconds=seconds,
                differing=differing_arrays(io.raw_arrays(out), want)))
            return out

    return Recording


class deterministic:
    """``torch.use_deterministic_algorithms(True)`` inside the block."""

    def __enter__(self):
        import torch
        self.prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        import torch
        torch.use_deterministic_algorithms(self.prev)


def phase_train_recovery(cfg, kernel: str, root: str, device="cuda",
                         batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                         steps: int = TRAIN_STEPS) -> dict:
    """Phase 11 (c): under deterministic algorithms, an uninterrupted
    run of ``steps`` steps, then the same run with a delta checkpoint
    store at ``root`` (every CKPT_EVERY-th step) and one injected
    failure at step CKPT_FAIL_AT, recovered from the store.  The
    restored state must equal the state saved at that step, and the
    recovered run's final state the uninterrupted run's, bit for bit.
    The verdict is ``recovery_failures``."""
    from repro_torch.checkpoint import io
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import FailureInjector

    tcfg, scfg = train_configs(cfg, batch, seq, steps)
    res = dict(arch=cfg.name, n_layers=cfg.n_layers, kernel=kernel,
               steps=steps, ckpt_every=CKPT_EVERY, fail_at=CKPT_FAIL_AT)
    inj = FailureInjector(fail_at=(CKPT_FAIL_AT,))
    plain_store = train_mod.DeltaCheckpointStore
    with deterministic():
        build.reset_launches()
        t0 = time.perf_counter()
        state, hist, _ = train_mod.train(cfg, tcfg, scfg, device=device,
                                         log_every=1)
        _sync(device)
        res["clean_s"] = time.perf_counter() - t0
        res["clean_launches"] = dict(build.LAUNCHES)
        res["clean_loss"] = hist.rows["loss"]
        clean = io.raw_arrays(state)
        del state
        train_mod.DeltaCheckpointStore = recording_store(plain_store)
        try:
            build.reset_launches()
            t0 = time.perf_counter()
            state, hist, store = train_mod.train(
                cfg, tcfg, scfg, device=device, ckpt_dir=root,
                ckpt_every=CKPT_EVERY, injector=inj, log_every=1)
            _sync(device)
        finally:
            train_mod.DeltaCheckpointStore = plain_store
    res["recovered_s"] = time.perf_counter() - t0
    res["launches"] = dict(build.LAUNCHES)
    res["fired"] = list(inj.fired)
    res["restores"] = store.restores
    res["save_s"] = store.save_s
    res["storage_bytes"] = store.storage_bytes()
    res["manifest"] = {k: store.manifest[k]
                       for k in ("steps", "snapshots", "deltas")}
    res["final_differing"] = differing_arrays(io.raw_arrays(state), clean)
    res["final_step"] = state.step
    res["loss"] = hist.rows["loss"]
    return res


def recovery_failures(res: dict) -> list:
    """Phase 11 (c)'s verdict: every failed check, named."""
    bad = []
    if [f[0] for f in res["fired"]] != ["step"]:
        bad.append(f"the injected failure fired {res['fired']}")
    if not res["restores"]:
        bad.append("recovery restored nothing")
    for r in res["restores"]:
        if r["step"] != r["saved_step"] or r["differing"]:
            bad.append(f"the state restored at step {r['step']} differs "
                       f"from the state saved at step {r['saved_step']} in "
                       f"{r['differing'][:5]}")
    if res["final_differing"]:
        bad.append(f"the recovered run's final state differs from the "
                   f"uninterrupted run's in {len(res['final_differing'])} "
                   f"arrays: {res['final_differing'][:5]}")
    if res["final_step"] != res["steps"]:
        bad.append(f"the recovered run ended at step {res['final_step']}")
    for what in ("clean_launches", "launches"):
        if not res[what].get(res["kernel"]):
            bad.append(f"{what}: {res['kernel']} never launched")
    return bad


def step1_router_logits(state, cfg, tcfg, device) -> dict:
    """Every MoE layer's router logits [T, E] (on the host) in the
    forward of training step 1 from ``state``, over step 0's batch."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.models import api
    from repro_torch.models.moe import route
    batch = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len, seed=tcfg.seed,
                        device=device).batch_at(0)
    seen = {}

    def read(layer, mod, x):
        if layer not in seen:
            seen[layer] = route(mod, x.reshape(-1, x.shape[-1]),
                                cfg).logits.float().cpu()
    with torch.no_grad(), moe_inputs(state.params, read):
        api.loss_fn(state.params, batch, cfg)
    return seen


def step1_route_flips(card: dict, cpu: dict, k: int) -> list:
    """Each token whose top-k experts differ between the card's and the
    CPU's router logits, judged by C7's near-tie test (``route_flip``,
    the CPU in the forward's place)."""
    flips = []
    for layer in sorted(cpu):
        for t in range(cpu[layer].shape[0]):
            f = route_flip(card[layer][t], cpu[layer][t], k)
            if f:
                flips.append(dict(layer=layer, token=t, **f))
    return flips


def phase_train_card_cpu(cfg, seed: int, device="cuda",
                         batch: int = CHECK_TRAIN_BATCH,
                         seq: int = CHECK_TRAIN_SEQ,
                         steps: int = CHECK_TRAIN_STEPS) -> dict:
    """Phase 11 (d) / 15 (b): ``cfg`` in float32 trained ``steps`` steps
    (``make_train_step`` over ``SyntheticLM``'s batches, as
    ``launch.train.train`` runs them) on ``device`` and on the CPU from
    the same initial parameters (drawn from the seeded CPU generator
    that ``init_train_state`` uses, and read bit-equal on both devices):
    per-step loss and grad norm, as relative differences; for the MoE
    family also step 1's routes on both (``step1_route_flips``).  The
    verdict is ``card_cpu_failures``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.checkpoint import io
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.runtime import init_train_state, make_train_step

    tcfg, scfg = train_configs(cfg, batch, seq, steps, "float32")
    # the two draws side by side, each from a generator of its own: a
    # CPU generator draws one value after another (mixtral's float32
    # layer is 1.45 G values)
    with ThreadPoolExecutor(2) as pool:
        drawn = {dev: pool.submit(init_train_state, cfg, tcfg, device=dev)
                 for dev in (device, "cpu")}
        states = {dev: f.result() for dev, f in drawn.items()}
    init_differing = differing_arrays(io.raw_arrays(states[device].params),
                                      io.raw_arrays(states["cpu"].params))
    flips = None
    if cfg.family == "moe":
        logits = {dev: step1_router_logits(st, cfg, tcfg, dev)
                  for dev, st in states.items()}
        flips = step1_route_flips(logits[device], logits["cpu"], cfg.top_k)
    rows = {}
    for dev, state in states.items():
        build.reset_launches()
        step = make_train_step(cfg, tcfg, scfg)
        data = SyntheticLM(cfg, batch, seq, seed=tcfg.seed, device=dev)
        rows[dev] = {"loss": [], "grad_norm": [], "step_s": []}
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, data.batch_at(i))
            for k in ("loss", "grad_norm"):
                rows[dev][k].append(float(m[k]))
            rows[dev]["step_s"].append(time.perf_counter() - t0)
        if dev == device:
            launches = dict(build.LAUNCHES)
        states[dev] = None
    rel = {m: [abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(rows[device][m], rows["cpu"][m])]
           for m in ("loss", "grad_norm")}
    return dict(arch=cfg.name, n_layers=cfg.n_layers, batch=batch, seq=seq,
                steps=steps, launches=launches,
                init_differing=init_differing, route_flips=flips,
                loss_card=rows[device]["loss"], loss_cpu=rows["cpu"]["loss"],
                step_s_card=rows[device]["step_s"],
                step_s_cpu=rows["cpu"]["step_s"],
                rel=rel, max_rel=max(max(v) for v in rel.values()))


def card_cpu_failures(r: dict) -> list:
    """Phase 11 (d) / 15 (b)'s verdict on ``phase_train_card_cpu``."""
    bad = []
    if r["init_differing"]:
        bad.append(f"initial parameters differ in {r['init_differing'][:5]}")
    if not r["max_rel"] <= F32_TRAIN_CARD_CPU_RTOL:
        bad.append(f"float32 card and CPU disagree: {r['rel']}")
    far = [f for f in r.get("route_flips") or [] if not f["near_tie"]]
    if far:
        bad.append(f"{len(far)} step-1 route flips are no near-tie: "
                   f"{far[:3]}")
    return bad


def card_cpu_line(r: dict) -> str:
    flips = r.get("route_flips")
    return (f"train {r['arch']}: float32 card vs CPU, {r['n_layers']} "
            f"layers, {r['batch']}x{r['seq']}, {r['steps']} steps: loss card "
            + ", ".join(f"{x:.6f}" for x in r["loss_card"]) + " / CPU "
            + ", ".join(f"{x:.6f}" for x in r["loss_cpu"])
            + "; rel err loss " + ", ".join(f"{x:.3g}" for x in
                                           r["rel"]["loss"])
            + ", grad norm " + ", ".join(f"{x:.3g}" for x in
                                         r["rel"]["grad_norm"])
            + f" (tolerance {F32_TRAIN_CARD_CPU_RTOL:.3g}); step s card "
            + ", ".join(f"{x:.2f}" for x in r["step_s_card"]) + " / CPU "
            + ", ".join(f"{x:.2f}" for x in r["step_s_cpu"])
            + f"; initial parameters bit-equal: {not r['init_differing']}"
            + ("" if flips is None else
               f"; step-1 route flips {len(flips)} (gap, delta: "
               + ", ".join(f"{f['gap']:.4g} <= {f['delta']:.4g}"
                           if f["near_tie"] else
                           f"{f['gap']:.4g} > {f['delta']:.4g}"
                           for f in flips[:8]) + ")"))


def phase_training(layers: int, seed: int) -> dict:
    """Phase 11 on the card: (a) smollm-360m and (b) mamba2-130m trained
    at full width (depth ``layers`` or the published one), (c) mamba2's
    delta checkpoints and recovery in a temporary root, removed after,
    (d) both models' float32 card-versus-CPU training.  Raises on the
    first part that fails."""
    import torch
    out = {}
    for arch, kernel in (("smollm-360m", "flash_attention"),
                         ("mamba2-130m", "ssd_scan")):
        cfg = lm_config(arch, layers)
        t0 = time.perf_counter()
        r = phase_train(cfg, kernel, seed)
        r["phase_s"] = time.perf_counter() - t0
        for line in train_lines(r):
            print(line, flush=True)
        bad = train_failures(r)
        if bad:
            raise AssertionError(f"train {arch}: " + "; ".join(bad))
        out[arch] = r
        gc.collect()
        torch.cuda.empty_cache()

    cfg = lm_config("mamba2-130m", min(layers or RECOVERY_LAYERS,
                                       RECOVERY_LAYERS))
    print(f"train recovery mamba2-130m: depth {cfg.n_layers} of 24 layers, "
          f"cut for the script's time (RECOVERY_LAYERS: its saves and "
          f"restores are host npz work, ~32 s at 6 layers on one H100 at "
          f"700 W, the slowest host measured)", flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        r = phase_train_recovery(cfg, "ssd_scan", root)
        r["phase_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sb = r["storage_bytes"]
    print(f"train recovery mamba2-130m: {cfg.n_layers} layers, deterministic "
          f"algorithms; uninterrupted {r['clean_s']:.2f} s, recovered "
          f"{r['recovered_s']:.2f} s; manifest {r['manifest']}; storage "
          f"snapshots {sb['snapshots']} B, deltas {sb['deltas']} B; save s "
          + ", ".join(f"{x:.3f}" for x in r["save_s"]) + "; restore s "
          + ", ".join(f"{x['seconds']:.3f}" for x in r["restores"])
          + f"; restored == saved: "
          f"{[not x['differing'] for x in r['restores']]}; final state == "
          f"uninterrupted: {not r['final_differing']} "
          f"({len(r['final_differing'])} arrays differ)", flush=True)
    bad = recovery_failures(r)
    if bad:
        raise AssertionError("train recovery: " + "; ".join(bad))
    out["recovery"] = r
    gc.collect()
    torch.cuda.empty_cache()

    out["card_cpu"] = {}
    for arch in ("smollm-360m", "mamba2-130m"):
        r = phase_train_card_cpu(lm_config(arch, CHECK_TRAIN_LAYERS), seed)
        print(card_cpu_line(r), flush=True)
        bad = card_cpu_failures(r)
        if bad:
            raise AssertionError(f"train {arch}: " + "; ".join(bad))
        out["card_cpu"][arch] = r
    return out


# ---------------------------------------------------------------------------
# Phase 15: every served family trains on the card; the dense LM on a mesh

# (a): whisper-small's decoder at Whisper's text context over its 1500
# frames, internvl2-1b at 2048 tokens after its 256 patches, mixtral at
# 2048 tokens; bf16 params
FAMILY_TRAIN = (("whisper-small", WHISPER_TEXT_CTX),
                ("internvl2-1b", TRAIN_SEQ))
# depth cuts, made when phase 15 (c) began to serve: the whole script
# read 1120 and 1293 s on one H100 at 700 W with (a) at published depth
# and mixtral at 2 layers (the card's host sets the spread), against a
# 1200 s limit on the whole run.  (a) trains whisper-small 6 + 6 of its 12 + 12 layers
# and internvl2-1b 12 of 24; (a) and (c) train mixtral at most
# MOE_TRAIN_MAX_LAYERS deep, whatever ``moe_train_depth`` reckons
FAMILY_TRAIN_LAYERS = {"whisper-small": 6, "internvl2-1b": 12}
MOE_TRAIN_MAX_LAYERS = 1
# (a) mixtral's depth: bf16 param and gradient, float32 moments
MOE_TRAIN_BYTES_PER_PARAM = 12
# a step's memory beside the state: the plain attention backward at (8,
# 32, 2048², float32) holds a few 4.3 GB score-sized tensors, the logits
# and their gradient 2 × 2.1 GB, AdamW's float32 temporaries of one 470
# M-entry expert stack ~9.4 GB (one part at a time)
MOE_TRAIN_TRANSIENT_BYTES = 24 * 2 ** 30
# the outputs remat="block" keeps, a layer: 8 experts' [5120, 14336] gate
# and up and [5120, 4096] down products and the q / k / v / o projections,
# bf16
MOE_TRAIN_SAVED_BYTES_PER_LAYER = 3 * 10 ** 9
# (b): 1 layer of whisper-small (1 + 1), internvl2-1b and mixtral, at
# published width.  whisper and internvl2 were cut from 2 layers when
# (c) began to train them on the mesh (its float32 check holds 2 layers
# of each, mesh against plain on the card): their CPU steps took 5.8-7.8
# s at 2 layers on one H100's host at 700 W (the slowest measured)
FAMILY_CHECK_LAYERS = {"whisper-small": 1, "internvl2-1b": 1,
                       MOE_ARCH: 1}
# (b)'s steps, cut from CHECK_TRAIN_STEPS for the script's time: on an
# H100's host (8 cores) the CPU side of a step took 4.2-7.8 s (whisper,
# internvl2) and 47.5-57.9 s (mixtral, its 1.45 B float32 parameters);
# one step still holds each model's forward, backward (and mixtral's
# routes) to the CPU's; the AdamW update that a second step read is held
# by phase 11 (d)'s three steps.  Whisper's and internvl2's cut from 2
# when phase 18 began to serve gemma-2b, olmo-1b and glm4-9b
FAMILY_CHECK_STEPS = {"whisper-small": 1, "internvl2-1b": 1, MOE_ARCH: 1}
# (c): smollm-360m at published size on the mesh; 2 float32 layers, 8 ×
# 256 tokens, 3 steps, mesh against the plain step within the
# reference's own bound (test_distributed.py:496-499)
MESH_ARCH, MESH_CHECK_SEQ, MESH_ATOL = "smollm-360m", 256, 1e-4
# phase 17: the dry-run's peak over the measured one, fixed before the
# first run on the card
DRYRUN_MEMORY_RATIO = (0.5, 2.0)
DRYRUN_CHILD_TIMEOUT_S = 600
MESH_CHILD_TIMEOUT_S = 900
# (c) also trains mixtral-8x7b (published width and 8 experts, as deep
# as ``moe_train_depth`` reckons) and mamba2-130m (published size) on
# the mesh: bf16 through ``train(mesh=)``, then a float32 check, mesh
# step against plain step on the card, within the reference's own
# bounds (test_distributed.py:454-458 for the moe family, :496-499 for
# ssm).  Cut, and printed, to hold the script near its 895 s: 4 bf16
# steps of TRAIN_STEPS (a warm median of 3), 2 float32 steps of CHECK_TRAIN_STEPS, mixtral's
# check at 1 layer and, since the int8 step and phase 17 came, 1 step.
# whisper-small and internvl2-1b train as in (a), at
# FAMILY_TRAIN_LAYERS' depths and FAMILY_TRAIN's sequences, with a
# float32 check of 2 layers (whisper 2 + 2) within MESH_ATOL; mamba2
# trains at 12 of its 24 layers (MESH_TRAIN_LAYERS, cut with them for
# the script's time; ~8 s at 24 on one H100 at 700 W, the slowest host
# measured)
MESH_TRAIN_LAYERS = {"mamba2-130m": 12, **FAMILY_TRAIN_LAYERS}
MESH_MODELS = {MOE_ARCH: dict(steps=4, check_layers=1, check_steps=1,
                              atol=2e-4),
               "mamba2-130m": dict(steps=4, check_layers=2, check_steps=2,
                                   atol=MESH_ATOL),
               "whisper-small": dict(steps=4, check_layers=2, check_steps=2,
                                     atol=MESH_ATOL),
               "internvl2-1b": dict(steps=4, check_layers=2, check_steps=2,
                                    atol=MESH_ATOL)}


def moe_train_params(cfg) -> int:
    """``cfg``'s parameter count (router included)."""
    return sum(stored_params(cfg, n_moe_layers(cfg)))


def moe_train_depth(cfg, free_bytes: int, override: int = 0) -> tuple:
    """Phase 15 (a)'s mixtral depth and its reckoning, as printed: the
    deepest n (down from the published depth) whose training state at
    MOE_TRAIN_BYTES_PER_PARAM, kept products and MOE_TRAIN_TRANSIENT_BYTES
    fit ``free_bytes``; ``override`` (``--lm-layers``) if given.  The
    width and the experts are never cut."""
    import dataclasses

    def need(n):
        c = dataclasses.replace(cfg, n_layers=n)
        return (MOE_TRAIN_BYTES_PER_PARAM * moe_train_params(c)
                + n * MOE_TRAIN_SAVED_BYTES_PER_LAYER
                + MOE_TRAIN_TRANSIENT_BYTES)
    n = override or cfg.n_layers
    while not override and n > 1 and need(n) > free_bytes:
        n -= 1
    if override:
        return n, f"{n} of {cfg.n_layers} layers (--lm-layers)"
    embed = moe_train_params(dataclasses.replace(cfg, n_layers=0))
    layer = moe_train_params(dataclasses.replace(cfg, n_layers=1)) - embed
    return n, (f"{n} of {cfg.n_layers} layers (a layer {layer:,} params, "
               f"embeddings {embed:,}; {MOE_TRAIN_BYTES_PER_PARAM} B a "
               f"param + {MOE_TRAIN_SAVED_BYTES_PER_LAYER / 1e9:.1f} GB kept "
               f"a layer + {MOE_TRAIN_TRANSIENT_BYTES / 2 ** 30:.0f} GiB "
               f"transient: {n} layers need {need(n) / 1e9:.1f} GB, "
               f"{n + 1} need {need(n + 1) / 1e9:.1f} GB; free "
               f"{free_bytes / 1e9:.1f} GB)")


def family_check_config(arch: str, n: int | None = None):
    """``arch`` at published width and ``n`` layers (default phase 15
    (b)'s cut, FAMILY_CHECK_LAYERS; an encoder-decoder: as many encoder
    layers)."""
    return at_depth(lm_config(arch, 0), n or FAMILY_CHECK_LAYERS[arch])


def at_depth(cfg, n: int):
    """``cfg`` at ``n`` layers (an encoder-decoder: ``n`` + ``n``)."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=n, **(
        {"n_enc_layers": n} if cfg.family == "encdec" else {}))


def moe_train_cut(free_bytes: int, layers: int) -> tuple:
    """Phases 15 (a) and (c)'s mixtral depth and its reckoning, as
    printed: ``moe_train_depth``'s, at most MOE_TRAIN_MAX_LAYERS (the
    script's time) unless ``layers`` (``--lm-layers``) is given."""
    n, cut = moe_train_depth(lm_config(MOE_ARCH, 0), free_bytes, layers)
    if not layers and n > MOE_TRAIN_MAX_LAYERS:
        n, cut = MOE_TRAIN_MAX_LAYERS, (
            f"{MOE_TRAIN_MAX_LAYERS} of 32 layers, cut for the script's "
            f"time (the card holds {cut})")
    return n, cut


def host_free_gib() -> float:
    """The host's available memory (``/proc/meminfo``), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def phase_family_training(layers: int, seed: int, smi: str) -> dict:
    """Phase 15 (a) and (b): whisper-small, internvl2-1b and mixtral-8x7b
    trained at published width (at FAMILY_TRAIN_LAYERS' depths; mixtral
    as ``moe_train_cut`` reckons) and their float32 card-vs-CPU checks;
    the verdicts are ``train_failures`` and ``card_cpu_failures``,
    collected."""
    import torch
    out, bad = {"train": {}, "card_cpu": {}}, []
    for arch, seq in FAMILY_TRAIN + ((MOE_ARCH, TRAIN_SEQ),):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = lm_config(arch, layers)
        if arch in FAMILY_TRAIN_LAYERS and not layers:
            cfg = family_check_config(arch, FAMILY_TRAIN_LAYERS[arch])
            print(f"train {arch}: depth {cfg.n_layers} of "
                  f"{lm_config(arch, 0).n_layers} layers, cut for the "
                  f"script's time", flush=True)
        if arch == MOE_ARCH:
            n, cut = moe_train_cut(torch.cuda.mem_get_info()[0], layers)
            print(f"train {arch}: depth {cut}", flush=True)
            cfg = lm_config(arch, n)
            out["moe_depth"] = dict(layers=n, cut=cut)
        t0 = time.perf_counter()
        r = phase_train(cfg, "flash_attention", seed, seq=seq,
                        param_dtype="bfloat16")
        r["phase_s"] = time.perf_counter() - t0
        for line in train_lines(r, smi):
            print(line, flush=True)
        bad += [f"train {arch}: {b}" for b in train_failures(r)]
        out["train"][arch] = r
    for arch in FAMILY_CHECK_LAYERS:
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train {arch}: float32 card vs CPU, {FAMILY_CHECK_LAYERS[arch]}"
              f" layer(s) of published width (FAMILY_CHECK_LAYERS, cut for "
              f"the script's time: a step's CPU side is its largest part), "
              f"host memory available {host_free_gib():.1f} GiB", flush=True)
        t0 = time.perf_counter()
        r = phase_train_card_cpu(
            family_check_config(arch), seed,
            steps=FAMILY_CHECK_STEPS[arch])
        r["phase_s"] = time.perf_counter() - t0
        print(card_cpu_line(r), flush=True)
        bad += [f"train {arch}: {b}" for b in card_cpu_failures(r)]
        out["card_cpu"][arch] = r
    out["failures"] = bad
    return out


def model_kernel(cfg) -> str:
    """The kernel a training step of ``cfg`` launches: the SSD scan for
    the SSM family, flash attention for the others."""
    return "ssd_scan" if cfg.family == "ssm" else "flash_attention"


class first_routes:
    """A global forward hook: inside the ``with``, the top-k experts
    ([T, k], on the host) of each of the first ``n`` MoE calls, routed
    from the call's input and router as gathered tensors (a DTensor's
    gather is a collective every process of the mesh takes part in)."""

    def __init__(self, cfg, n: int):
        self.cfg, self.n, self.topi, self.hook = cfg, n, [], None

    def __enter__(self):
        from torch.nn.modules.module import register_module_forward_hook

        from repro_torch.models.moe import MoE, route_by

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        def read(mod, args, out):
            if isinstance(mod, MoE) and len(self.topi) < self.n:
                x = full(args[0]).detach()
                self.topi.append(route_by(
                    full(mod.wg).detach(), x.reshape(-1, x.shape[-1]),
                    self.cfg).topi.cpu())
        self.hook = register_module_forward_hook(read)
        return self

    def __exit__(self, *exc):
        self.hook.remove()


def pairs_routed_differently(a: list, b: list) -> int:
    """The (token, choice) pairs whose expert one side's routes ([T, k]
    a layer) chose and the other's did not."""
    return sum(int(x.shape[1]) * int(x.shape[0]) - int(
        (x[:, :, None] == y[:, None, :]).any(-1).sum())
        for x, y in zip(a, b))


def state_gap(a, b) -> tuple:
    """Two TrainStates on one device (either may be on a mesh): the
    largest |Δ| over their parameters, in float64, and whether every
    leaf (parameters, moments, counters) is bit-equal; read on the
    device, leaf by leaf, nothing copied to the host."""
    import torch

    from repro_torch.checkpoint import io

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()
    other = dict(io.leaves(b))
    gap, same = 0.0, True
    for name, x in io.leaves(a):
        y = other.pop(name, None)
        if not isinstance(x, torch.Tensor):
            same = same and x == y
            continue
        x, y = full(x), full(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            same = False
            continue
        if name.startswith("params/"):
            gap = max(gap, float((x.double() - y.double()).abs().max()))
        same = same and torch.equal(x.contiguous().view(torch.uint8),
                                    y.contiguous().view(torch.uint8))
    return gap, same and not other


def train_from(state, cfg, tcfg, scfg, dev, mesh=None) -> tuple:
    """``tcfg.total_steps`` steps of ``make_train_step`` from ``state``
    over ``SyntheticLM``'s batches, as ``launch.train.train`` runs them
    (on ``mesh``: the state resharded, each batch placed, the step in
    its context).  Returns (the state, the losses)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.runtime import make_train_step, reshard_state
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

    step = make_train_step(cfg, tcfg, scfg)
    data = SyntheticLM(cfg, tcfg.global_batch, tcfg.seq_len, seed=tcfg.seed,
                       device=dev)
    if mesh is not None:
        state = reshard_state(state, mesh)
    losses = []
    for i in range(tcfg.total_steps):
        batch = data.batch_at(i)
        if mesh is None:
            state, m = step(state, batch)
        else:
            with mesh_context(mesh):
                state, m = step(state, place_tree(
                    batch, batch_sharding(batch, mesh)))
        losses.append(float(m["loss"]))
    return state, losses


def mesh_model_run(full, mesh, dev, *, batch: int, seq: int, steps: int,
                   check_layers: int, check_seq: int, check_steps: int,
                   atol: float) -> tuple:
    """``full`` trained on ``mesh``: (1) in bf16 through
    ``launch.train.train(mesh=)``, counters zeroed around it; (2)
    ``check_layers`` float32 layers trained from one initial state on
    the mesh (its launches counted) and plainly on the same device
    (``train_from``), for a MoE model with the routes of each run's
    first forward (``first_routes``).  Returns (the results, the float32
    mesh run's state)."""
    import copy

    import torch

    from repro_torch.kernels import build
    from repro_torch.launch.train import train
    from repro_torch.runtime import init_train_state

    tcfg, scfg = train_configs(full, batch, seq, steps, "bfloat16")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    t0 = time.perf_counter()
    _, hist, _ = train(full, tcfg, scfg, device=dev, log_every=1, mesh=mesh)
    _sync(dev)
    res = dict(arch=full.name, family=full.family, kernel=model_kernel(full),
               n_layers=full.n_layers, batch=batch, seq=seq, steps=steps,
               train_s=time.perf_counter() - t0,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else None),
               launches=dict(build.LAUNCHES),
               per_step=launches_per_step(full, scfg),
               loss=hist.rows["loss"], grad_norm=hist.rows["grad_norm"],
               step_s=[ms / 1e3 for ms in hist.rows["step_ms"]])

    t0 = time.perf_counter()
    cfg = at_depth(full, check_layers)
    tcfg, scfg = train_configs(cfg, batch, check_seq, check_steps,
                               "float32")
    n_moe = n_moe_layers(cfg) if cfg.n_experts else 0
    start = [init_train_state(cfg, tcfg, device=dev)]
    with first_routes(cfg, n_moe) as plain_routes:
        plain, loss_plain = train_from(copy.deepcopy(start[0]), cfg, tcfg,
                                       scfg, dev)
    build.reset_launches()
    # popped, so that no reference here keeps the initial state alive
    # once the run has resharded it: mixtral's float32 layer is 20.5 GB
    # a state, and the card holds three only without the step's own
    with first_routes(cfg, n_moe) as mesh_routes:
        meshed, loss_mesh = train_from(start.pop(), cfg, tcfg, scfg, dev,
                                       mesh)
    _sync(dev)
    launches = dict(build.LAUNCHES)
    gap, bit_equal = state_gap(meshed, plain)
    del plain
    res["check"] = dict(
        layers=check_layers, seq=check_seq, steps=check_steps, atol=atol,
        launches=launches, per_step=launches_per_step(cfg, scfg),
        loss_mesh=loss_mesh, loss_plain=loss_plain,
        loss_diff=max(abs(x - y) for x, y in zip(loss_mesh, loss_plain)),
        param_diff=gap, bit_equal=bit_equal,
        routes_differing=(pairs_routed_differently(mesh_routes.topi,
                                                   plain_routes.topi)
                          if n_moe else None),
        moe_calls=len(mesh_routes.topi), seconds=time.perf_counter() - t0)
    return res, meshed


def mesh_model_config(arch: str, layers: int, device_type: str) -> tuple:
    """Phase 15 (c)'s config of ``arch`` and its cut, as printed: mixtral
    at published width, as deep as ``moe_train_cut`` reckons from the
    card's free memory; whisper-small and internvl2-1b at phase 15 (a)'s
    depth and mamba2-130m at 12 layers (MESH_TRAIN_LAYERS); any other
    at published size (or ``layers``)."""
    import torch
    if arch in MESH_TRAIN_LAYERS and not layers:
        cfg = family_check_config(arch, MESH_TRAIN_LAYERS[arch])
        return cfg, (f"{cfg.n_layers} of {lm_config(arch, 0).n_layers} "
                     f"layers, cut for the script's time "
                     f"(MESH_TRAIN_LAYERS)")
    if arch != MOE_ARCH:
        cfg = lm_config(arch, layers)
        return cfg, f"{cfg.n_layers} layers"
    free = (torch.cuda.mem_get_info()[0] if device_type == "cuda"
            else 64 * 2 ** 30)
    n, cut = moe_train_cut(free, layers)
    return lm_config(arch, n), cut


def hybrid_mesh_reckoning() -> str:
    """Why phase 15 (c) runs no jamba mesh step on one card: one MoE
    layer's training state against the card's memory."""
    import torch
    cfg = hybrid_config()
    n = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    need = n * MOE_TRAIN_BYTES_PER_PARAM
    total = torch.cuda.get_device_properties(0).total_memory
    return (f"train {HYBRID_ARCH} on a mesh: not run; one MoE layer is "
            f"{cfg.n_experts} x 3 x {cfg.d_model} x {cfg.d_ff} = {n:,} "
            f"params, at {MOE_TRAIN_BYTES_PER_PARAM} B a param "
            f"{need / 1e9:.1f} GB of training state, more than the card's "
            f"{total / 1e9:.1f} GB: it waits for a second card")


# the training state a parameter with the int8 optimizer state
# (``optim/adamw.py``, state dtype "int8"): a bf16 parameter and its bf16
# gradient, int8 ``m`` and ``v`` (their scales one a leaf); activations
# and AdamW's temporaries come on top
INT8_TRAIN_BYTES_PER_PARAM = 6


def int8_train_reckonings(total_bytes: int) -> list:
    """Why phase 15 trains neither jamba-1.5-large nor kimi-k2 on one
    card, even with the int8 optimizer state: the smallest model of each
    that still runs every kind of layer at published width — jamba's
    period with one MoE layer's experts, the other three sharing them (as
    phase 16 serves it), and kimi-k2's one layer (phase 19's layer with
    experts of its own) — its parameters as ``hybrid_model`` stores them
    (``stored_params``) at INT8_TRAIN_BYTES_PER_PARAM, against
    ``total_bytes``."""
    lines = []
    for cfg, what in ((hybrid_config(), "one period (8 layers) with one MoE "
                       "layer's experts, the other 3 sharing them"),
                      (lm_config(KIMI_ARCH, 1), "one layer with its 384 "
                       "experts and the untied tables")):
        n = sum(stored_params(cfg, 1))
        need = n * INT8_TRAIN_BYTES_PER_PARAM
        lines.append(
            f"train {cfg.name} on one card with the int8 optimizer state: "
            f"{'not run; ' if need > total_bytes else ''}{what} is {n:,} "
            f"params, at {INT8_TRAIN_BYTES_PER_PARAM} B a param (bf16 param "
            f"and gradient, int8 m and v) {need / 1e9:.1f} GB of training "
            f"state before any activation, "
            + ("more than" if need > total_bytes else "within")
            + f" the card's {total_bytes / 1e9:.1f} GB")
    return lines


# (c) also serves on the world-1 mesh: mamba2-130m, whisper-small and
# internvl2-1b at published size, smollm-360m and mixtral-8x7b at
# MESH_SERVE_LAYERS' depths and jamba-1.5-large's one period with
# ``hybrid_distinct_moe``'s experts, each a prefill of LM_BATCH x
# LM_PROMPT (whisper 416 tokens over 1500 float32 frames, internvl2
# after its 256 patches: phase 14's shapes, the stub from
# ``SyntheticLM``) and LM_DECODE greedy steps on the mesh and plainly,
# from one draw of the weights (the earlier phases that serve these
# models have freed theirs by now: the same seeds and generators draw
# them again).  At world 1 every local shard is the whole tensor, so the
# mesh's logits must equal the plain path's bit for bit
MESH_SERVE = ("smollm-360m", "mamba2-130m", MOE_ARCH, HYBRID_ARCH,
              "whisper-small", "internvl2-1b")
# depth cuts of (c)'s serving, made when it began to serve whisper-small
# and internvl2-1b, for the script's time: a mesh decode step is
# host-bound (DTensor dispatch), on one H100 at 700 W (the slowest host
# measured) 531 ms for
# mixtral's 24 layers (its 32 steps and the plain path's ~28 s), 398
# ms for smollm's 32 (~16 s) and 138 ms for mamba2's 24 (~6 s).  Phase
# 13 serves mixtral at 24 layers, phases 5 and 6 smollm at 32 and
# mamba2 at 24, plainly
MESH_SERVE_LAYERS = {"smollm-360m": 8, "mamba2-130m": 12, MOE_ARCH: 4,
                     "internvl2-1b": 12}


def mesh_and_plain(model, mesh) -> tuple:
    """``model``'s parameters moved onto ``mesh`` by the parameter rules
    (``sharding.place``) one at a time, each original let go once placed
    (a copy of a whole ~70 GB model does not fit beside it; shared
    Parameters stay shared), and a plain model whose parameters are the
    mesh model's local tensors: at world 1 each is the whole tensor, so
    the two share their storage.  Returns (the mesh model, the plain
    one); ``model`` is the mesh model afterwards."""
    import copy

    import torch

    from repro_torch.sharding import named_shardings, place
    sh = named_shardings(model, mesh)
    placed = {}
    for prefix, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            if id(p) not in placed:
                s = sh[f"{prefix}.{name}" if prefix else name]
                placed[id(p)] = torch.nn.Parameter(
                    place(p.detach(), s.mesh, s.spec), requires_grad=False)
            mod._parameters[name] = placed[id(p)]
            del p
    plain = copy.deepcopy(model, {
        id(p): torch.nn.Parameter(p.detach().to_local(), requires_grad=False)
        for p in placed.values()})
    return model, plain


def serve_timed(model, cfg, prompts, decode: int, dev, mesh=None,
                extra=None) -> dict:
    """A prefill of ``prompts`` (with the batch's ``extra`` inputs:
    ``frames`` or ``patches``; a cold one first, its caches let go) and
    ``decode`` greedy steps through ``models.api`` (the vlm's positions
    after its patches), on ``mesh`` (the batch placed by
    ``batch_sharding``, in its context) or plainly: the counters zeroed
    before the warm prefill and before the decode and read after each,
    the clock after a synchronize, every step's logits kept
    (gathered)."""
    import contextlib

    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.models import api
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

    batch = {"tokens": prompts, **(extra or {})}
    if mesh is not None:
        batch = place_tree(batch, batch_sharding(batch, mesh))
    start = prompts.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    cap = start + decode

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    res = {}
    with mesh_context(mesh) if mesh is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        _, caches = api.prefill(model, batch, cfg, cache_cap=cap)
        del caches
        _sync(dev)
        res["prefill_cold_s"] = time.perf_counter() - t0
        build.reset_launches()
        t0 = time.perf_counter()
        logits, caches = api.prefill(model, batch, cfg, cache_cap=cap)
        out = [full(logits)]
        _sync(dev)
        res["prefill_s"] = time.perf_counter() - t0
        res["prefill_launches"] = dict(build.LAUNCHES)
        build.reset_launches()
        t0 = time.perf_counter()
        for i in range(decode):
            logits, caches = api.decode_step(model, out[-1].argmax(-1)[:, None],
                                             start + i, caches, cfg)
            out.append(full(logits))
        _sync(dev)
        res["decode_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / decode
        res["decode_launches"] = dict(build.LAUNCHES)
    res["logits"] = out
    return res


def mesh_serve(model, cfg, mesh, dev, *, seed: int, batch: int,
               prompt: int, decode: int, cut: str) -> dict:
    """Phase 15 (c)'s serving of ``model`` (``cfg``, bf16 on ``dev``) on
    the world-1 ``mesh`` against the plain path on the same weights
    (``mesh_and_plain``) and prompts (seeded as phases 5, 6, 13 and 16
    seed theirs; an encdec's float32 frames or a vlm's patches from
    ``SyntheticLM``): ``serve_timed`` plainly, then on the mesh; each
    step's logits compared bit for bit.  The verdict is
    ``mesh_serve_failures``."""
    import numpy as np
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.data.synthetic import stub_rows

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt))).to(dev)
    drawn = SyntheticLM(cfg, batch, prompt, seed=seed, device=dev).batch_at(0)
    extra = {k: drawn[k] for k in stub_rows(cfg)}
    model, plain = mesh_and_plain(model, mesh)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    res = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
               cut=cut, batch=batch, prompt=prompt, decode=decode,
               stub={k: [*v.shape, str(v.dtype)[6:]]
                     for k, v in extra.items()},
               want=(prefill_launches_want(cfg, "flash_attention")
                     if cfg.family == "encdec" else hybrid_launches_want(cfg)),
               mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
    res["plain"] = serve_timed(plain, cfg, prompts, decode, dev, extra=extra)
    del plain
    gc.collect()
    res["mesh_run"] = serve_timed(model, cfg, prompts, decode, dev, mesh,
                                  extra)
    a, b = res["mesh_run"].pop("logits"), res["plain"].pop("logits")
    res["bit_equal"] = [torch.equal(x.contiguous().view(torch.uint8),
                                    y.contiguous().view(torch.uint8))
                        for x, y in zip(a, b)]
    res["max_abs_diff"] = max(float((x - y).abs().max()) for x, y in zip(a, b))
    res["finite"] = all(bool(torch.isfinite(x).all()) for x in a)
    res["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if cuda else None)
    return res


def mesh_serve_config(arch: str, layers: int, device_type: str) -> tuple:
    """Phase 15 (c)'s served config of ``arch`` and its cut, as printed
    (None where the card does not hold it): mixtral at published width,
    as deep as ``moe_depth`` reckons from the free memory, at most
    MESH_SERVE_LAYERS; jamba's one period with ``hybrid_distinct_moe``'s
    distinct MoE layers (None below HYBRID_MIN_DISTINCT); any other at
    published size or MESH_SERVE_LAYERS' depth (or ``layers``).
    Returns (config, cut, distinct)."""
    import torch
    free = (torch.cuda.mem_get_info()[0] if device_type == "cuda"
            else 128 * 2 ** 30)
    if arch == MOE_ARCH:
        n, cut = moe_depth(lm_config(arch, 0), free, layers)
        if not layers and n > MESH_SERVE_LAYERS[arch]:
            n, cut = MESH_SERVE_LAYERS[arch], (
                f"{MESH_SERVE_LAYERS[arch]} of 32 layers, cut for the "
                f"script's time (MESH_SERVE_LAYERS; the card holds {cut})")
        return lm_config(arch, n), cut, None
    if arch == HYBRID_ARCH:
        cfg = hybrid_config()
        distinct, cut = hybrid_distinct_moe(cfg, free)
        return (cfg if distinct >= HYBRID_MIN_DISTINCT else None), cut, \
            distinct
    if arch in MESH_SERVE_LAYERS and not layers:
        cfg = lm_config(arch, MESH_SERVE_LAYERS[arch])
        return cfg, (f"{cfg.n_layers} of {lm_config(arch, 0).n_layers} "
                     f"layers, cut for the script's time "
                     f"(MESH_SERVE_LAYERS)"), None
    cfg = lm_config(arch, layers)
    return cfg, f"{cfg.n_layers} layers", None


def mesh_serve_model(cfg, seed: int, distinct, dev):
    """The weights phases 5, 6, 13 and 16 serve ``cfg`` with: bf16 from a
    generator on ``dev`` seeded ``seed`` (jamba: ``hybrid_model``)."""
    import torch

    from repro_torch.models import api
    if distinct is not None:
        return hybrid_model(cfg, seed, distinct, torch.bfloat16, dev)
    return api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           torch.bfloat16, dev)


def mesh_serve_failures(r: dict) -> list:
    """The verdict on one of phase 15 (c)'s served models: each prefill's
    and each decode step's logits bit-equal to the plain path's and
    finite; the mesh's launches those of the plain path, a prefill's as
    ``hybrid_launches_want`` says (a kernel a layer), none in decode."""
    bad = []
    eq = r["bit_equal"]
    if not all(eq):
        bad.append(f"the mesh's logits differ from the plain path's at "
                   f"{[i for i, e in enumerate(eq) if not e][:8]} of "
                   f"{len(eq)} calls (0 the prefill; max |diff| "
                   f"{r['max_abs_diff']:.3g})")
    if not r["finite"]:
        bad.append("non-finite logits on the mesh")
    m, p = r["mesh_run"], r["plain"]
    for what in ("prefill_launches", "decode_launches"):
        if {k: v for k, v in m[what].items() if v} != \
                {k: v for k, v in p[what].items() if v}:
            bad.append(f"the mesh's {what.split('_')[0]} launched "
                       f"{m[what]}, the plain path's {p[what]}")
    got = {k: v for k, v in m["prefill_launches"].items() if v}
    if got != {k: v for k, v in r["want"].items() if v}:
        bad.append(f"a mesh prefill launched {got}, want {r['want']}")
    if any(m["decode_launches"].values()):
        bad.append(f"the mesh's decode launched {m['decode_launches']}")
    return bad


def mesh_serve_line(r: dict, smi: str) -> str:
    m, p = r["mesh_run"], r["plain"]
    launched = {k: v for k, v in m["prefill_launches"].items() if v}
    return (f"serve {r['arch']} on a mesh {r['mesh']} (world 1): "
            f"{r['cut']}, bf16, {r['batch']}x{r['prompt']} prompts + "
            f"{r['decode']} greedy steps; prefill s {m['prefill_s']:.4f} "
            f"(cold {m['prefill_cold_s']:.4f}; plain {p['prefill_s']:.4f}, "
            f"x{m['prefill_s'] / p['prefill_s']:.3f}); decode ms/step "
            f"{m['decode_ms_per_step']:.3f} (plain "
            f"{p['decode_ms_per_step']:.3f}, x"
            f"{m['decode_ms_per_step'] / p['decode_ms_per_step']:.3f}); "
            f"prefill launches {launched} (plain "
            f"{ {k: v for k, v in p['prefill_launches'].items() if v} }), "
            f"decode none; logits bit-equal to the plain path's at "
            f"{sum(r['bit_equal'])} of {len(r['bit_equal'])} calls"
            + ("" if r["peak_gib"] is None else
               f"; peak {r['peak_gib']:.2f} GiB") + f"  [{smi}]")


def memory_readout(dev, since: dict | None = None) -> dict:
    """What the caching allocator holds on the card ``dev`` (the caller
    collects garbage first): the bytes allocated and the active blocks
    of ``torch.cuda.memory_snapshot()``.  Given an earlier readout
    ``since``, also ``new``: the bytes in blocks made since, those of
    them in CUDA tensors the garbage collector reaches, grouped by
    (dtype, shape), and the rest (held where it does not reach: an
    autograd graph, a C++ cache)."""
    import collections

    import torch
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != dev.index:
            continue
        addr = seg["address"]
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                blocks[addr] = b["size"]
            addr += b["size"]
    res = dict(allocated=torch.cuda.memory_allocated(dev), blocks=blocks)
    if since is None:
        return res
    new_blocks = {a: v for a, v in blocks.items() if a not in since["blocks"]}
    reached, seen = collections.Counter(), set()
    # the collector's objects are walked only where new blocks are held
    for obj in gc.get_objects() if new_blocks else ():
        if type(obj) in (torch.Tensor, torch.nn.Parameter) and obj.is_cuda:
            st = obj.untyped_storage()
            if st.data_ptr() in new_blocks and st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                reached[f"{str(obj.dtype)[6:]}{list(obj.shape)}"] += \
                    st.nbytes()
    new = sum(new_blocks.values())
    res["new"] = dict(bytes=new, reached=sum(reached.values()),
                      not_reached=new - sum(reached.values()),
                      reached_by_shape=reached.most_common(6))
    return res


def memory_line(r: dict, start: int) -> str:
    """One of phase 15 (c)'s memory readouts, as printed."""
    gib = 2 ** 30
    return (f"15 (c) memory {r['part']}: {r['allocated'] / gib:.3f} "
            f"GiB allocated ({start / gib:.3f} at the start of (c)), "
            f"{r['bytes'] / gib:.3f} GiB of it in blocks made since: "
            f"{r['reached'] / gib:.3f} GiB in tensors the "
            f"collector reaches {r['reached_by_shape']}, "
            f"{r['not_reached'] / gib:.3f} GiB not reached")


def mesh_checks(rank: int, world: int, init: str, seed: int,
                device_type: str = "cuda", layers: int = 0,
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                steps: int = TRAIN_STEPS, check_layers: int = 2,
                check_seq: int = MESH_CHECK_SEQ,
                check_steps: int = CHECK_TRAIN_STEPS,
                root: str | None = None, cfg=None,
                models: dict | None = None, serve: bool = False) -> dict:
    """Phase 15 (c) on one process of a (data ``world``, model 1) mesh
    (``launch.mesh.make_test_mesh``; NCCL on the card, one process a
    card): (1) smollm-360m (depth ``layers`` or the published one) in
    bf16 through ``launch.train.train(mesh=)``, counters zeroed around
    it; (2) ``check_layers`` float32 layers trained on the mesh and
    plainly on the same device (``mesh_model_run``); (3)
    ``compressed_psum`` over the data dimension of the mesh run's
    gradients; (4) the mesh state saved through a delta store (``root``,
    this process's own) and ``reshard_from_checkpoint`` onto the mesh;
    (5) each of ``models`` (arch → config, None for
    ``mesh_model_config``'s) as (1) and (2), with ``MESH_MODELS``'s
    steps, check layers and bound; (6) if ``serve``, at world 1, each
    of ``MESH_SERVE`` at ``mesh_serve_config``'s config served on the
    mesh and plainly (``mesh_serve``: LM_BATCH x LM_PROMPT prompts,
    LM_DECODE steps), a model the card does not hold skipped with its
    reckoning; (7) last, at world 1, ``int8_mesh_step``.  ``cfg``
    replaces smollm-360m (a CPU rehearsal).  The verdict is
    ``mesh_failures``."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import DeltaCheckpointStore, io
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import compressed_psum
    from repro_torch.runtime import (init_train_state, make_grad_fn,
                                     reshard_from_checkpoint)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(world, 1, device_type=device_type)
        dev = torch.device(device_type, rank) if device_type == "cuda" \
            else torch.device("cpu")
        res = dict(world=world, mesh=dict(zip(mesh.mesh_dim_names,
                                              mesh.shape)), memory=[])
        start = memory_readout(dev) if device_type == "cuda" else None

        def readout(part: str) -> None:
            # what the parts before leave allocated, against the start of
            # (c); called after a garbage collection
            if start is None:
                return
            m = memory_readout(dev, start)
            r = dict(part=part, allocated=m["allocated"], **m["new"])
            res["memory"].append(r)
            if rank == 0:
                print(memory_line(r, start["allocated"]), flush=True)
        model = cfg or lm_config(MESH_ARCH, layers)
        run, meshed = mesh_model_run(
            model, mesh, dev, batch=batch, seq=seq, steps=steps,
            check_layers=check_layers, check_seq=check_seq,
            check_steps=check_steps, atol=MESH_ATOL)
        res.update(run)
        cfg = at_depth(model, check_layers)
        tcfg, scfg = train_configs(cfg, batch, check_seq, check_steps,
                                   "float32")

        batch0 = SyntheticLM(cfg, batch, check_seq, seed=tcfg.seed,
                             device=dev).batch_at(0)
        with mesh_context(mesh):
            grads = make_grad_fn(cfg, tcfg, scfg)(
                meshed.params,
                place_tree(batch0, batch_sharding(batch0, mesh)))[1]
            full = {n: g.full_tensor() for n, g in grads.items()}
            errs = {n: torch.zeros_like(g) for n, g in full.items()}
            tot, new_e = compressed_psum(full, errs, "data")
        res["psum_differing"] = psum_differing(
            {n: g.cpu().numpy() for n, g in full.items()},
            {n: t.cpu().numpy() for n, t in tot.items()},
            {n: t.cpu().numpy() for n, t in new_e.items()}, world)
        del batch0, grads, full, errs, tot, new_e

        store = DeltaCheckpointStore(root)
        store.save(check_steps - 1, meshed)
        saved = io.raw_arrays(meshed)
        restored = reshard_from_checkpoint(
            store, check_steps - 1,
            init_train_state(cfg, tcfg, device=dev), mesh)
        res["restore_differing"] = differing_arrays(
            io.raw_arrays(restored), saved)
        res["restore_on_mesh"] = all(
            p.device_mesh == mesh for p in restored.params.parameters())
        del meshed, saved, restored, store

        res["models"] = {}
        for arch, given in (models or {}).items():
            gc.collect()
            if device_type == "cuda":
                torch.cuda.empty_cache()
            readout(f"before training {arch}")
            if given is None:
                given, cut = mesh_model_config(arch, layers, device_type)
            else:
                cut = f"{given.n_layers} layers (given)"
            knobs = MESH_MODELS[arch]
            if rank == 0:
                print(f"train {arch} on a mesh: depth {cut}; {knobs['steps']}"
                      f" bf16 steps of {TRAIN_STEPS}, float32 check "
                      f"{knobs['check_layers']} layer(s) x "
                      f"{knobs['check_steps']} steps of "
                      f"{CHECK_TRAIN_STEPS}", flush=True)
            # whisper's decoder trains at its text context, as in (a);
            # the float32 mesh state is let go at once (a name bound to it
            # kept internvl2-1b's, 1.86 GiB, through the serving and the
            # int8 step, and mixtral's, 19.2 GiB, through mamba2's run)
            r = mesh_model_run(given, mesh, dev, batch=batch,
                               seq=min(seq, dict(FAMILY_TRAIN).get(arch,
                                                                   seq)),
                               check_seq=check_seq, **knobs)[0]
            r["cut"] = cut
            res["models"][arch] = r

        res["serve"], res["serve_skipped"] = {}, {}
        for arch in MESH_SERVE if serve else ():
            if world != 1:
                res["serve_skipped"][arch] = (
                    f"world {world}: the mesh-vs-plain comparison needs "
                    f"world 1 (wider meshes: the gloo CPU tests)")
                continue
            gc.collect()
            if device_type == "cuda":
                torch.cuda.empty_cache()
            readout(f"before serving {arch}")
            served, cut, distinct = mesh_serve_config(arch, layers,
                                                      device_type)
            if rank == 0:
                print(f"serve {arch} on a mesh: {cut}", flush=True)
            if served is None:
                res["serve_skipped"][arch] = cut
                continue
            res["serve"][arch] = mesh_serve(
                mesh_serve_model(served, seed, distinct, dev), served, mesh,
                dev, seed=seed, batch=LM_BATCH,
                prompt=dict(FAMILY_ARCHS).get(arch, LM_PROMPT),
                decode=LM_DECODE, cut=cut)
        if world == 1:
            gc.collect()
            if device_type == "cuda":
                torch.cuda.empty_cache()
            readout("before the int8 step")
            res["int8"] = int8_mesh_step(model, mesh, dev, batch=batch,
                                         seq=seq)
        return res
    finally:
        dist.destroy_process_group()


def state_to(state, dev):
    """A ``TrainState`` copied onto ``dev`` (an int8 moment's ``q`` and
    ``scale`` each moved)."""
    import copy
    import dataclasses

    from repro_torch.optim.adamw import QTensor

    def move(x):
        if isinstance(x, QTensor):
            return QTensor(q=x.q.to(dev), scale=x.scale.to(dev))
        return x.to(dev)
    return dataclasses.replace(
        state, params=copy.deepcopy(state.params).to(dev),
        opt=dataclasses.replace(
            state.opt, m={n: move(x) for n, x in state.opt.m.items()},
            v={n: move(x) for n, x in state.opt.v.items()}))


def int8_mesh_step(cfg, mesh, dev, *, batch: int, seq: int) -> dict:
    """Phase 15 (c)'s int8 step: one training step of ``cfg`` (bf16
    params, ``opt_state_dtype="int8"``) on the world-1 ``mesh`` and one
    plainly on ``dev``, from one initial state (built on the CPU) and
    one batch: every array of both states after it (every ``q``,
    ``scale`` and parameter) compared bit for bit.  The mesh step runs
    twice from that state, each timed: the first (cold, the first step
    of this model on the card) and the second (warm), with the peak
    counter reset just before the second and read after; phase 17
    holds its dry-run to that peak and divides its flops by that
    step's seconds.  ``started`` is the wall clock at the first step
    (phase 17 prints how long before it its child had ended)."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import io
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import batch_sharding
    from repro_torch.runtime import (init_train_state, make_train_step,
                                     reshard_state)
    from repro_torch.runtime.elastic import place_tree
    from repro_torch.sharding import mesh_context

    tcfg, scfg = train_configs(cfg, batch, seq, 1, "bfloat16")
    tcfg = dataclasses.replace(tcfg, opt_state_dtype="int8")
    start = init_train_state(cfg, tcfg, device="cpu")
    data = SyntheticLM(cfg, batch, seq, seed=tcfg.seed,
                       device=dev).batch_at(0)
    step = make_train_step(cfg, tcfg, scfg)
    cuda = dev.type == "cuda"
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=batch, seq=seq,
               per_step=launches_per_step(cfg, scfg), started=time.time())
    placed = place_tree(data, batch_sharding(data, mesh))

    def mesh_step():
        # the step updates the parameters in place: each run starts
        # from its own copy of ``start``
        meshed = reshard_state(start, mesh)
        _sync(dev)
        if cuda:
            out["allocated_before"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        build.reset_launches()
        t0 = time.perf_counter()
        with mesh_context(mesh):
            meshed, m = step(meshed, placed)
        _sync(dev)
        return meshed, m, time.perf_counter() - t0

    meshed, m, out["first_step_s"] = mesh_step()
    got = io.raw_arrays(meshed)
    out["q_placed"] = all(
        x.q.placements == p.placements
        for n, p in meshed.params.named_parameters()
        for x in (meshed.opt.m[n], meshed.opt.v[n]))
    out["loss"] = float(m["loss"])
    del meshed, m
    gc.collect()
    meshed, m, out["step_s"] = mesh_step()
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                         else None)
    out["launches"] = dict(build.LAUNCHES)
    del meshed, placed, m
    gc.collect()

    build.reset_launches()
    t0 = time.perf_counter()
    plain, m = step(state_to(start, dev), data)
    _sync(dev)
    out["plain_step_s"] = time.perf_counter() - t0
    out["plain_launches"] = dict(build.LAUNCHES)
    out["plain_loss"] = float(m["loss"])
    want = io.raw_arrays(plain)
    out["arrays"] = len(want)
    out["q_arrays"] = sum(k.endswith("/q") for k in want)
    out["differing"] = differing_arrays(got, want)
    del plain, m, start, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def int8_failures(r: dict) -> list:
    """Phase 15 (c)'s int8 step: the mesh and plain states bit-equal
    (every ``q``, ``scale`` and parameter), each ``q`` at its parameter's
    placement, B5 twice a layer in each step and no other kernel."""
    bad = []
    if r["differing"] or not r["q_arrays"]:
        bad.append(f"the int8 mesh and plain steps differ in "
                   f"{r['differing'][:5]} ({len(r['differing'])} of "
                   f"{r['arrays']} arrays)")
    if not r["q_placed"]:
        bad.append("an int8 moment's q is not at its parameter's placement")
    for what, launches in (("mesh", r["launches"]),
                           ("plain", r["plain_launches"])):
        want = {"flash_attention": r["per_step"]}
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            bad.append(f"the int8 {what} step launched {got}, want {want}")
    return bad


def int8_line(r: dict, smi: str) -> str:
    peak = (f"{r['peak_bytes'] / 2 ** 30:.2f} GiB"
            if r["peak_bytes"] is not None else "not measured")
    return (f"train {r['arch']} with the int8 optimizer state: "
            f"{r['n_layers']} layers, bf16, {r['batch']}x{r['seq']} "
            f"tokens; one step on the world-1 mesh {r['first_step_s']:.4f}"
            f" s cold, {r['step_s']:.4f} s warm (peak {peak}), plainly "
            f"{r['plain_step_s']:.4f} s; loss "
            f"{r['loss']:.6f} / {r['plain_loss']:.6f}; bit-equal "
            f"{not r['differing']} ({r['q_arrays']} q of {r['arrays']} "
            f"arrays); flash_attention "
            f"{r['launches'].get('flash_attention', 0)} / "
            f"{r['plain_launches'].get('flash_attention', 0)} (want "
            f"{r['per_step']} each)  [{smi}]")


def dryrun_child(layers: int, device: str = "cuda", cfg=None,
                 batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> int:
    """Phase 17's trace (``--dryrun-child``): ``run_cell`` of phase 15
    (c)'s int8 smollm-360m training cell on fake CUDA tensors, the
    world-1 mesh on the fake process group of this process; the result
    is the last line of its standard output.  ``device``, ``cfg``,
    ``batch`` and ``seq`` cut it for a CPU rehearsal."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    res = dryrun.run_cell(
        MESH_ARCH, "train", device=device,
        cfg=cfg or lm_config(MESH_ARCH, layers),
        shape=ShapeConfig("train", seq, batch, "train"),
        mesh_shape=(1, 1), rules_name="baseline", opt_state_dtype="int8",
        param_dtype="bfloat16")
    res["child_s"] = time.perf_counter() - t0
    res["ended"] = time.time()
    print(json.dumps(res), flush=True)
    return 0


def start_dryrun(layers: int, log_path: str):
    """Start phase 17's child (it traces on the host while phase 15 (c)
    runs on the card)."""
    f = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-child",
         "--lm-layers", str(layers)], stdout=f, stderr=subprocess.STDOUT), f


def phase_dryrun(child, log, log_path: str, int8: dict) -> dict:
    """Phase 17: the child's trace beside phase 15 (c)'s measured int8
    step."""
    t0 = time.perf_counter()
    rc = child.wait(timeout=DRYRUN_CHILD_TIMEOUT_S)
    log.close()
    with open(log_path) as f:
        text = f.read()
    res = dict(rc=rc, wait_s=time.perf_counter() - t0, log=text[-3000:])
    if rc == 0:
        res["trace"] = json.loads(text.strip().splitlines()[-1])
        mem = res["trace"]["memory_analysis"]
        res["peak_bytes"] = mem["peak_bytes"]
        res["measured_bytes"] = int8["peak_bytes"]
        res["ratio"] = mem["peak_bytes"] / int8["peak_bytes"]
        res["tflops"] = (res["trace"]["flops_per_device"] / int8["step_s"]
                         / 1e12)
        res["step_s"] = int8["step_s"]
        res["ended_before_s"] = int8["started"] - res["trace"]["ended"]
    return res


def dryrun_failures(r: dict) -> list:
    """Phase 17's verdict: the child ran, and the traced peak over the
    measured one lies in ``DRYRUN_MEMORY_RATIO``."""
    if r["rc"] != 0:
        return [f"the dry-run child exited {r['rc']}: {r['log'][-1500:]}"]
    lo, hi = DRYRUN_MEMORY_RATIO
    if not lo <= r["ratio"] <= hi:
        return [f"the dry-run's peak {r['peak_bytes']} B over the measured "
                f"{r['measured_bytes']} B is {r['ratio']:.4f}, outside "
                f"[{lo}, {hi}]"]
    return []


def dryrun_line(r: dict, smi: str) -> str:
    t, mem = r["trace"], r["trace"]["memory_analysis"]
    return (f"dry-run of phase 15 (c)'s int8 {t['arch']} cell (fake CUDA, "
            f"mesh {t['mesh']}, {t['rules']} rules; traced in "
            f"{t['setup_s']} + {t['trace_s']} s): peak "
            f"{mem['peak_bytes'] / 2 ** 30:.3f} GiB (arguments "
            f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f}, temporaries "
            f"{mem['temp_size_in_bytes'] / 2 ** 30:.3f}) against the "
            f"measured max_memory_allocated "
            f"{r['measured_bytes'] / 2 ** 30:.3f} GiB: ratio "
            f"{r['ratio']:.4f} (bound {list(DRYRUN_MEMORY_RATIO)}); "
            f"{t['flops_per_device']:.6g} traced flops (B5 counted as its "
            f"plain version, masked scores included) over the measured "
            f"warm {r['step_s']:.4f} s step: {r['tflops']:.2f} TFLOP/s; "
            f"the child ended {r['ended_before_s']:.1f} s before the "
            f"int8 steps began; bytes "
            f"{t['bytes_per_device']:.6g}; roofline {t['roofline']}  "
            f"[{smi}]")


def psum_differing(grads: dict, out: dict, new_err: dict,
                   world: int) -> list:
    """The leaves where ``compressed_psum`` of ``grads`` (the same on each
    of ``world`` processes, zero error feedback) differs from the
    reference's arithmetic in numpy: scale max|g| / 127 (1.0 if 0), the
    int32 sum of ``world`` equal quantized copies, the residual."""
    import numpy as np
    f32 = np.float32
    bad = []
    for n, g in grads.items():
        g = g.astype(f32)
        a = f32(np.abs(g).max()) / f32(127.0)
        a = a if a > 0 else f32(1.0)
        gq = np.clip(np.round(g / a), -127, 127).astype(np.int32)
        want = (gq * world).astype(f32) * a
        err = g - gq.astype(f32) * a
        if out[n].tobytes() != want.tobytes() or \
                new_err[n].tobytes() != err.tobytes():
            bad.append(n)
    return bad


def mesh_failures(res: dict, plain_step_s: float | None = None) -> list:
    """Phase 15 (c)'s verdict on rank 0's ``mesh_checks``."""
    bad = []
    k, per = "flash_attention", res["per_step"]
    if res["launches"].get(k, 0) != per * res["steps"]:
        bad.append(f"the mesh run launched {k} {res['launches'].get(k, 0)} "
                   f"times, want {per * res['steps']}")
    others = {n: c for n, c in res["launches"].items() if n != k and c}
    if others:
        bad.append(f"the mesh run launched {others}")
    if not all(math.isfinite(x) for x in res["loss"] + res["grad_norm"]):
        bad.append(f"non-finite loss {res['loss']} or grad norm "
                   f"{res['grad_norm']}")
    c = res["check"]
    if not (c["loss_diff"] <= MESH_ATOL and c["param_diff"] <= MESH_ATOL):
        bad.append(f"float32 mesh and plain steps differ: loss "
                   f"{c['loss_diff']:.3g}, parameters {c['param_diff']:.3g} "
                   f"(bound {MESH_ATOL})")
    if res["psum_differing"]:
        bad.append(f"compressed_psum differs from the reference's "
                   f"arithmetic in {res['psum_differing'][:5]}")
    if res["restore_differing"] or not res["restore_on_mesh"]:
        bad.append(f"reshard_from_checkpoint differs in "
                   f"{res['restore_differing'][:5]} (on the mesh: "
                   f"{res['restore_on_mesh']})")
    if "int8" in res:
        bad += int8_failures(res["int8"])
    for arch, r in res.get("models", {}).items():
        bad += [f"{arch}: {b}" for b in mesh_model_failures(r)]
    for arch, r in res.get("serve", {}).items():
        bad += [f"serving {arch}: {b}" for b in mesh_serve_failures(r)]
    return bad


def mesh_model_failures(r: dict) -> list:
    """The verdict on one of phase 15 (c)'s ``models``: its kernel
    launched once a call a step (forward and remat's recompute) in the
    bf16 run and in the float32 mesh run, no other kernel, finite
    losses, and the float32 mesh and plain steps within the bound."""
    bad = []
    k = r["kernel"]
    c = r["check"]
    for what, launches, want in (
            ("bf16", r["launches"], r["per_step"] * r["steps"]),
            ("float32", c["launches"], c["per_step"] * c["steps"])):
        if launches.get(k, 0) != want:
            bad.append(f"the {what} mesh run launched {k} "
                       f"{launches.get(k, 0)} times, want {want}")
        others = {n: v for n, v in launches.items() if n != k and v}
        if others:
            bad.append(f"the {what} mesh run launched {others}")
    if not all(math.isfinite(x) for x in r["loss"] + r["grad_norm"]):
        bad.append(f"non-finite loss {r['loss']} or grad norm "
                   f"{r['grad_norm']}")
    if not (c["loss_diff"] <= c["atol"] and c["param_diff"] <= c["atol"]):
        bad.append(f"float32 mesh and plain steps differ: loss "
                   f"{c['loss_diff']:.3g}, parameters {c['param_diff']:.3g} "
                   f"(bound {c['atol']})")
    return bad


def mesh_line(res: dict, plain_step_s: float, smi: str) -> str:
    c = res["check"]
    ws = warm_median(res["step_s"])
    return (f"train {res['arch']} on a mesh {res['mesh']} ({res['world']} "
            f"process(es), NCCL): {res['n_layers']} layers, bf16, "
            f"{res['batch']}x{res['seq']} tokens; step s "
            + ", ".join(f"{x:.4f}" for x in res["step_s"])
            + f" (warm median {ws:.4f}; plain step of phase 11 "
            f"{plain_step_s:.4f}, x{ws / plain_step_s:.3f}); "
            f"flash_attention {res['launches'].get('flash_attention', 0)} "
            f"(want {res['per_step']} a step); loss "
            + ", ".join(f"{x:.4f}" for x in res["loss"])
            + f"; float32 {c['layers']} layers x {c['steps']} steps, mesh "
            f"vs plain: loss {c['loss_diff']:.3g}, parameters "
            f"{c['param_diff']:.3g} (bound {MESH_ATOL}), bit-equal "
            f"{c['bit_equal']}; compressed_psum == numpy form: "
            f"{not res['psum_differing']}; reshard_from_checkpoint "
            f"bit-equal: {not res['restore_differing']}  [{smi}]")


def mesh_model_line(r: dict, plain: tuple | None, smi: str) -> str:
    """One of phase 15 (c)'s ``models``, as printed; ``plain`` (what,
    step seconds) names a plain run of the same model, width and depth
    to set the mesh step beside."""
    c = r["check"]
    ws = warm_median(r["step_s"])
    k = r["kernel"]
    peak = r.get("peak_gib")
    return (f"train {r['arch']} on a mesh: {r['n_layers']} layers, bf16, "
            f"{r['batch']}x{r['seq']} tokens"
            + ("" if peak is None else f", peak {peak:.2f} GiB")
            + "; step s "
            + ", ".join(f"{x:.4f}" for x in r["step_s"])
            + f" (warm median {ws:.4f}"
            + ("" if plain is None else
               f"; {plain[0]} {plain[1]:.4f}, x{ws / plain[1]:.3f}")
            + f"); {k} {r['launches'].get(k, 0)} (want {r['per_step']} a "
            f"step); loss " + ", ".join(f"{x:.4f}" for x in r["loss"])
            + f"; float32 {c['layers']} layer(s) x {c['steps']} steps, mesh "
            f"vs plain: loss {c['loss_diff']:.3g}, parameters "
            f"{c['param_diff']:.3g} (bound {c['atol']}), bit-equal "
            f"{c['bit_equal']}, {k} {c['launches'].get(k, 0)} (want "
            f"{c['per_step'] * c['steps']})"
            + ("" if c["routes_differing"] is None else
               f"; first forward's pairs routed differently "
               f"{c['routes_differing']} over {c['moe_calls']} MoE calls")
            + f"  [{smi}]")


def mesh_child(rank: int, world: int, init: str, seed: int,
               layers: int) -> int:
    """A process of phase 15 (c)'s mesh beyond the first (``--mesh-child``:
    one a card, started by rank 0)."""
    root = tempfile.mkdtemp(prefix=f"chip_smoke_mesh_{rank}_")
    try:
        mesh_checks(rank, world, init, seed, layers=layers, root=root,
                    models=dict.fromkeys(MESH_MODELS),
                    serve=True)
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_mesh(seed: int, layers: int) -> dict:
    """Phase 15 (c): a (data n, model 1) mesh over the n visible cards,
    one process a card: this process is rank 0 and starts the others;
    a ``file://`` rendezvous in a temporary directory.  At world 1 the
    int8 step runs last (``int8_mesh_step``)."""
    import torch
    world = torch.cuda.device_count()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    init = f"file://{work}/rendezvous"
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child",
         str(r), str(world), init, "--seed", str(seed), "--lm-layers",
         str(layers)]) for r in range(1, world)]
    try:
        res = mesh_checks(0, world, init, seed, layers=layers,
                          root=os.path.join(work, "ckpt"),
                          models=dict.fromkeys(MESH_MODELS),
                          serve=True)
        res["children"] = [p.wait(timeout=MESH_CHILD_TIMEOUT_S)
                           for p in children]
        return res
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense-nodes", type=int, default=8192)
    ap.add_argument("--edge-nodes", type=int, default=131072)
    ap.add_argument("--edge-e-cap", type=int, default=1 << 21)
    ap.add_argument("--lm-layers", type=int, default=0,
                    help="cut the LMs' depth, served and trained (0: the "
                         "published depth; mixtral's as the card holds)")
    ap.add_argument("--hybrid-distinct", type=int, default=0,
                    help="phase 16's MoE layers with experts of their own "
                         "(0: as many as the card holds)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--first-call", action="store_true",
                    help="build with ptxas's report, run small kernel "
                         "cases against their plain versions and stop")
    ap.add_argument("--dryrun-child", action="store_true",
                    help="phase 17's trace, in a process of its own")
    ap.add_argument("--crash-child", metavar="ROOT",
                    help="phase 8's child: run the dense configuration "
                         "durably at ROOT and die mid-swap (the parent "
                         "starts it)")
    ap.add_argument("--replica-child", nargs=2,
                    metavar=("PUBLISH_ROOT", "MIRROR"),
                    help="phase 9's child: reopen the replica mirror, "
                         "sync it from the publish root and die mid-sync "
                         "(the parent starts it)")
    ap.add_argument("--mesh-child", nargs=3,
                    metavar=("RANK", "WORLD", "INIT"),
                    help="phase 15 (c)'s process RANK of WORLD (one a card; "
                         "rank 0 starts it)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run phases 3, 4 and 10 and stop; on a host with "
                         "several cards phase 10's mesh spans them")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # cuBLAS's deterministic workspace, read when its first handle is
    # made: phase 11 (c) trains under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # segments that grow in place, read when the allocator starts:
    # phase 13's ~70 GB model needs memory that earlier phases freed,
    # not reserved blocks of the wrong sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as exc:
        return fail(f"the repository's port is not beside this script "
                    f"({exc})")
    if torch.backends.cuda.matmul.allow_tf32:
        return fail("TF32 matmul is on; the f32 measures need it off")
    if args.first_call:
        return first_call(args.seed)
    if args.crash_child:
        return crash_child(args.crash_child, args.dense_nodes, args.seed)
    if args.replica_child:
        return replica_child(*args.replica_child)
    if args.mesh_child:
        rank, world, init = args.mesh_child
        return mesh_child(int(rank), int(world), init, args.seed,
                          args.lm_layers)
    if args.dryrun_child:
        return dryrun_child(args.lm_layers)
    phases = {}

    t0 = time.perf_counter()
    build.ext()
    phases["build_s"] = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"build: {phases['build_s']:.1f} s", flush=True)
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    dense_ops = make_ops(args.dense_nodes, args.seed)
    edge_ops = make_ops(args.edge_nodes, args.seed)
    phases["generate_s"] = time.perf_counter() - t0

    # phase 2 — stores built from the sessions' op streams
    if not args.sharded_only:
        t0 = time.perf_counter()
        cases = kernel_cases(*graph_stores(
            dense_ops, edge_ops, args.dense_nodes, args.edge_nodes,
            args.edge_e_cap, args.seed), args.seed)
        rows = phase_kernels(cases)
        del cases
        torch.cuda.empty_cache()
        rows += phase_kernels(lm_kernel_cases(args.seed))
        torch.cuda.empty_cache()
        phases["kernels_s"] = time.perf_counter() - t0
        kernels = main_rows(rows)

    # phases 3 and 4 — the main path, counters zeroed just before each
    dense_expect = {"delta_apply": True, "edge_delta_apply": True,
                    "degree_series": True, "sweep_series": True}
    edge_expect = {"delta_apply": False, "edge_delta_apply": True,
                   "degree_series": True, "sweep_series": True}
    dense, dense_mem = phase_session("dense", dense_ops, args.dense_nodes,
                                     "dense", args.seed, dense_expect)
    edge, edge_mem = phase_session("edge", edge_ops, args.edge_nodes, "edge",
                                   args.seed, edge_expect,
                                   e_cap=args.edge_e_cap)

    # phase 10 — multi-device serving on a mesh naming the card SHARDS
    # times: a dense session built on it, phase 4's store placed on it
    sharded = {}
    for layout, ops, n, mem in (
            ("dense", dense_ops, args.dense_nodes, dense_mem),
            ("edge", edge_ops, args.edge_nodes, edge_mem)):
        store = mem.pop("store")
        t0 = time.perf_counter()
        sharded[layout] = phase_sharded(
            layout, ops, n, layout, args.seed, mem,
            store=store if layout == "edge" else None)
        phases[f"sharded_{layout}_s"] = time.perf_counter() - t0
        del store
    gc.collect()
    torch.cuda.empty_cache()
    if args.sharded_only:
        print(json.dumps({"phases": phases, "sharded": sharded},
                         default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # phases 7 and 8 — durable and indexed, reopened on the card; one
    # crash.  The roots live in a temporary directory, removed after.
    work = tempfile.mkdtemp(prefix="chip_smoke_roots_")
    try:
        t0 = time.perf_counter()
        durable = {
            "dense": phase_durable(
                "dense", dense_ops, args.dense_nodes, "dense", args.seed,
                dense_mem, dense_expect, "delta_apply",
                os.path.join(work, "dense")),
            "edge": phase_durable(
                "edge", edge_ops, args.edge_nodes, "edge", args.seed,
                edge_mem, edge_expect, "edge_delta_apply",
                os.path.join(work, "edge"), e_cap=args.edge_e_cap)}
        phases["durable_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        crash = phase_crash(dense_ops, args.dense_nodes, args.seed,
                            os.path.join(work, "crash"))
        phases["crash_s"] = time.perf_counter() - t0
        # phase 9 — replication: a writer, replicas on the card, a router
        gc.collect()
        torch.cuda.empty_cache()
        replication = {}
        for layout, ops, n, e_cap, mem in (
                ("dense", dense_ops, args.dense_nodes, None, dense_mem),
                ("edge", edge_ops, args.edge_nodes, args.edge_e_cap,
                 edge_mem)):
            t0 = time.perf_counter()
            os.makedirs(os.path.join(work, f"replication_{layout}"))
            replication[layout] = phase_replication(
                layout, ops, n, layout, args.seed, mem,
                os.path.join(work, f"replication_{layout}"), e_cap=e_cap)
            phases[f"replication_{layout}_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del dense_mem, edge_mem
    # the sessions' graphs of objects hold card memory until the cycle
    # collector runs; phase 12 and the LM phases read from here
    gc.collect()
    torch.cuda.empty_cache()
    # phase 12 — the paper's serving driver on every visible card and on
    # cuda:0 named four times
    t0 = time.perf_counter()
    serving = phase_serve(args.dense_nodes, SERVE_QUERIES, args.seed)
    phases["serve_s"] = time.perf_counter() - t0
    print(serve_line(serving, smi.splitlines()[0]), flush=True)
    bad = serve_failures(serving)
    if bad:
        raise AssertionError("; ".join(bad))
    gc.collect()
    torch.cuda.empty_cache()
    lms = {}
    profile_device(lambda: torch.zeros(1, device="cuda") + 1)  # CUPTI start-up
    for arch, kernel in (("smollm-360m", "flash_attention"),
                         ("mamba2-130m", "ssd_scan")):
        t0 = time.perf_counter()
        lms[arch] = phase_lm(lm_config(arch, args.lm_layers), kernel,
                             args.seed)
        phases[f"{arch}_s"] = time.perf_counter() - t0
        bad = family_failures(lms[arch])
        if bad:
            raise AssertionError("; ".join(bad))
    # phase 18 — gemma-2b, olmo-1b and glm4-9b at published width and
    # depth, one at a time; each frees what it holds.  Read after phase
    # 11, as phase 14's
    dense_lms = {}
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        dense_lms[arch] = phase_dense(lm_config(arch, args.lm_layers),
                                      args.seed)
        phases[f"{arch}_s"] = time.perf_counter() - t0
        print(dense_line(dense_lms[arch], smi.splitlines()[0]), flush=True)
    dense_bad = [b for r in dense_lms.values() for b in dense_failures(r)]
    for b in dense_bad:
        log(f"chip_smoke: phase 18: {b}")
    # phase 14 — the encoder-decoder and the vlm at published width and
    # depth; each frees what it holds
    families = {}
    for arch, prompt in FAMILY_ARCHS:
        t0 = time.perf_counter()
        families[arch] = phase_family(lm_config(arch, args.lm_layers),
                                      args.seed, prompt)
        phases[f"{arch}_s"] = time.perf_counter() - t0
        for line in family_lines(families[arch], smi.splitlines()[0]):
            print(line, flush=True)
    # read after phase 11, as phase 13's
    family_bad = [b for r in families.values() for b in family_failures(r)]
    for b in family_bad:
        log(f"chip_smoke: phase 14: {b}")
    # phase 13 — mixtral-8x7b at full width, as deep as the card holds,
    # once the memory earlier phases held is free
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    layers, cut = moe_depth(lm_config(MOE_ARCH, 0),
                            torch.cuda.mem_get_info()[0], args.lm_layers)
    moe = phase_moe(lm_config(MOE_ARCH, layers), args.seed, cut=cut)
    phases[f"{MOE_ARCH}_s"] = time.perf_counter() - t0
    for line in moe_lines(moe, smi.splitlines()[0]):
        print(line, flush=True)
    # read after phase 11, so that a failure here hides none of its checks
    moe_bad = moe_failures(moe)
    for b in moe_bad:
        log(f"chip_smoke: phase 13: {b}")
    # phase 16 — jamba-1.5-large, one published period at full width, as
    # many MoE layers with experts of their own as the card holds
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hybrid_cfg = hybrid_config()
    distinct, cut = hybrid_distinct_moe(
        hybrid_cfg, torch.cuda.mem_get_info()[0], args.hybrid_distinct)
    hybrid = phase_hybrid(hybrid_cfg, args.seed, distinct, cut=cut)
    phases[f"{HYBRID_ARCH}_s"] = time.perf_counter() - t0
    for line in hybrid_lines(hybrid, smi.splitlines()[0]):
        print(line, flush=True)
    hybrid_bad = hybrid_failures(hybrid)
    for b in hybrid_bad:
        log(f"chip_smoke: phase 16: {b}")
    # phase 19 — kimi-k2 at published width: one layer's 384 experts, the
    # layers past it routing over them, as deep as KIMI_LAYERS
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kimi_cfg = lm_config(KIMI_ARCH, 0)
    distinct, layers, cut = kimi_depth(
        kimi_cfg, torch.cuda.mem_get_info()[0], args.lm_layers)
    print(f"{KIMI_ARCH}: {cut}", flush=True)
    kimi = phase_kimi(at_depth(kimi_cfg, layers), args.seed, distinct,
                      cut=cut)
    phases[f"{KIMI_ARCH}_s"] = time.perf_counter() - t0
    for line in kimi_lines(kimi, smi.splitlines()[0]):
        print(line, flush=True)
    kimi_bad = kimi_failures(kimi)
    for b in kimi_bad:
        log(f"chip_smoke: phase 19: {b}")
    # phase 11 — training: both LMs, delta checkpoints and recovery, the
    # float32 card against the CPU
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training = phase_training(args.lm_layers, args.seed)
    phases["train_s"] = time.perf_counter() - t0
    # phase 15 — every served family trains on the card; the dense LM on
    # a mesh of the visible cards.  Read at the end, as phase 13's.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family_train = phase_family_training(args.lm_layers, args.seed,
                                         smi.splitlines()[0])
    phases["family_train_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry_log = os.path.join(os.path.dirname(args.out), "dryrun_child.txt")
    os.makedirs(os.path.dirname(dry_log), exist_ok=True)
    dry_child, dry_file = start_dryrun(args.lm_layers, dry_log)
    try:
        mesh = phase_mesh(args.seed, args.lm_layers)
    except BaseException:
        dry_child.kill()
        dry_child.wait()
        raise
    phases["mesh_s"] = time.perf_counter() - t0
    if "int8" in mesh:
        print(int8_line(mesh["int8"], smi.splitlines()[0]), flush=True)
    print(mesh_line(mesh, warm_median(training["smollm-360m"]["step_s"]),
                    smi.splitlines()[0]), flush=True)
    for arch, r in mesh["models"].items():
        a = family_train["train"].get(arch)
        plain = (("phase 15 (a)'s plain step", warm_median(a["step_s"]))
                 if a and (a["n_layers"], a["seq"]) == (r["n_layers"],
                                                        r["seq"])
                 else None)
        print(mesh_model_line(r, plain, smi.splitlines()[0]), flush=True)
    print(hybrid_mesh_reckoning(), flush=True)
    train_reckonings = int8_train_reckonings(
        torch.cuda.get_device_properties(0).total_memory)
    for line in train_reckonings:
        print(line, flush=True)
    for r in mesh["serve"].values():
        print(mesh_serve_line(r, smi.splitlines()[0]), flush=True)
    for arch, why in mesh["serve_skipped"].items():
        print(f"serve {arch} on a mesh: not run; {why}", flush=True)
    train_bad = family_train["failures"] + mesh_failures(mesh) + [
        f"mesh process {r} exited {c}"
        for r, c in enumerate(mesh["children"], 1) if c]
    for b in train_bad:
        log(f"chip_smoke: phase 15: {b}")
    # phase 17 — the dry-run of 15 (c)'s int8 cell beside its measurement
    # (the int8 step, and so phase 17, runs at world 1 only)
    t0 = time.perf_counter()
    dry, dry_bad = {"skipped": f"world {mesh['world']}"}, []
    if "int8" in mesh:
        dry = phase_dryrun(dry_child, dry_file, dry_log, mesh["int8"])
        dry_bad = dryrun_failures(dry)
    else:
        dry_child.kill()
        dry_child.wait()
        dry_file.close()
        print(f"phase 17: not run at world {mesh['world']}", flush=True)
    phases["dryrun_wait_s"] = time.perf_counter() - t0
    if "trace" in dry and not dry_bad:
        phases["dryrun_child_s"] = dry["trace"]["child_s"]
        print(dryrun_line(dry, smi.splitlines()[0]), flush=True)
    for b in dry_bad:
        log(f"chip_smoke: phase 17: {b}")
    phases["dense_session_s"] = dense["seconds"]
    phases["dense_cpu_s"] = dense["cpu_seconds"]
    phases["edge_session_s"] = edge["seconds"]
    phases["edge_cpu_s"] = edge["cpu_seconds"]
    # launches on the main path: the two sessions, and each LM's
    # prefill + decode
    runs = {"dense": dense["launches"], "edge": edge["launches"]}
    for layout, d in durable.items():
        runs[f"{layout} durable"] = d["launches"]
        runs[f"{layout} reopen"] = d["reopen_launches"]
    runs["crash reopen"] = crash["launches"]
    for layout, r in sharded.items():
        runs[f"{layout} sharded"] = r["launches"]
    for layout, r in replication.items():
        runs[f"{layout} replication"] = r["launches"]
    for name, r in serving["runs"].items():
        runs[f"serve {name}"] = r["launches"]
    for arch, r in (list(lms.items()) + list(dense_lms.items())
                    + list(families.items())
                    + [(MOE_ARCH, moe), (HYBRID_ARCH, hybrid),
                       (KIMI_ARCH, kimi)]):
        runs[arch] = {k: r["prefill_launches"][k] + r["decode_launches"][k]
                      for k in r["prefill_launches"]}
    for arch in lms:
        runs[f"{arch} train"] = training[arch]["launches"]
        runs[f"{arch} train float32 (card vs CPU)"] = \
            training["card_cpu"][arch]["launches"]
    runs["mamba2-130m train uninterrupted"] = \
        training["recovery"]["clean_launches"]
    runs["mamba2-130m train recovered"] = training["recovery"]["launches"]
    for arch, r in family_train["train"].items():
        runs[f"{arch} train"] = r["launches"]
    for arch, r in family_train["card_cpu"].items():
        runs[f"{arch} train float32 (card vs CPU)"] = r["launches"]
    runs[f"{MESH_ARCH} train on a mesh"] = mesh["launches"]
    if "int8" in mesh:
        runs[f"{MESH_ARCH} int8 train on a mesh"] = mesh["int8"]["launches"]
        runs[f"{MESH_ARCH} int8 train (plain)"] = \
            mesh["int8"]["plain_launches"]
    for arch, r in mesh["models"].items():
        runs[f"{arch} train on a mesh"] = r["launches"]
        runs[f"{arch} train float32 on a mesh"] = r["check"]["launches"]
    for arch, r in mesh["serve"].items():
        m = r["mesh_run"]
        runs[f"{arch} served on a mesh"] = {
            k: m["prefill_launches"].get(k, 0) + m["decode_launches"].get(k, 0)
            for k in set(m["prefill_launches"]) | set(m["decode_launches"])}
    for k in kernels:
        k["launches_by_run"] = {run: n.get(k["name"], 0)
                               for run, n in runs.items()}
        k["launches"] = sum(k["launches_by_run"].values())
        print(f"kernel {k['name']}: {k['ms']:.4f} ms (host "
              f"{k['host_ms']:.4f} ms)  plain "
              f"{k['plain_ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})  launches {k['launches']} "
              f"{k['launches_by_run']}"
              + "".join(f"  {n} {v}" for n, v in k.get("design", {}).items()),
              flush=True)

    report = dict(card=smi, torch=torch.__version__,
                  cuda=torch.version.cuda, kernels=kernels, phases=phases,
                  dense=dense, edge=edge, durable=durable, crash=crash,
                  replication=replication, sharded=sharded,
                  serving=serving, lms=lms, dense_lms=dense_lms,
                  families=families, moe=moe,
                  hybrid=hybrid, kimi=kimi,
                  training=training, family_train=family_train, mesh=mesh,
                  train_reckonings=train_reckonings,
                  dryrun=dry, args=vars(args))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels, "phases": phases}))
    if (moe_bad or family_bad or train_bad or hybrid_bad or dry_bad
            or dense_bad or kimi_bad):
        return fail("; ".join([f"phase 13: {b}" for b in moe_bad]
                              + [f"phase 14: {b}" for b in family_bad]
                              + [f"phase 15: {b}" for b in train_bad]
                              + [f"phase 16: {b}" for b in hybrid_bad]
                              + [f"phase 17: {b}" for b in dry_bad]
                              + [f"phase 18: {b}" for b in dense_bad]
                              + [f"phase 19: {b}" for b in kimi_bad]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
