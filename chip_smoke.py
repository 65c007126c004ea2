"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from ``src/repro_torch/csrc`` with nvcc for sm_90a (one
   nvcc per source, run together): the six TPU kernels' counterparts, flash
   attention as two kernels (Hopper and SIMT routes), the port's own PDL
   gather, Sada-C and WT listing kernels and a pointer-chase probe; ptxas's
   registers and spills of the flash kernels.
2. Full path: ``RetrievalService`` built on the card for dna-p001 at
   scale 3.2 (n = 1,024,320, d = 320) without the top-k PDL; ``plan``,
   ``count`` and ``list_docs`` (engines auto, ilcp, brute, pdl) on batches
   of 32 patterns, held against a host oracle from the port's own document
   array.  Every call goes through the service's program cache: one CUDA
   graph per (kind, bucket, window), captured at a bucket's first call and
   replayed after.  Each call's launches are those of one replay of each
   program it ran (``REPLAY_LAUNCHES``: 1 backward search per ``plan`` /
   ``count``; 2 + 1 ILCP + 1 PDL gather per ``list_docs`` of every engine,
   1 + 1 + 1 with a pinned window), and once more for a program the call
   captured (its warm-up run); each answer is bit-identical to the same
   work run eagerly on the same padded batch.  Then ``compile_counts``,
   each capture's seconds and pool bytes, per-batch latencies of graph and
   eager in turns on the same batches, and one warm ``list_docs[auto]``
   batch profiled both ways (wall, device ms, activities, busy share).
2b. Top-k and tf-idf on a ``RetrievalService`` with both PDLs for
   dna-p001 at scale 1.6 (n = 256,160, d = 160; the top-k PDL's host
   build, which keeps every internal node's list, does not finish at
   scale 3.2 within the run's time), on batches of 32: ``topk`` (k = 10,
   engines auto, brute, pdl, ilcp, and auto with a pinned brute window)
   held to a host (tf desc, id asc) oracle over DA[lo:hi], exact wherever
   the candidate buffer does not truncate the row (the oracle replays the
   PDL cover to count the entries the gather takes); ``tfidf`` with two
   terms per query as the serving CLI builds them, ranked-AND and
   ranked-OR, held to a host float32 oracle with the same fold within
   2 ulp.  Through the program cache as in phase 2: launches per call (2
   backward searches, 1 pinned, + 1 PDL gather per ``topk``; 1 + 1 per
   ``tfidf``), each answer bit-identical to the eager run,
   ``compile_counts``, captures, graph and eager latencies per batch, and
   one warm ``topk[pdl]`` and ``tfidf[or]`` batch profiled both ways; each
   batch's engine mix.
3. Large index, no PDL: suffix data, CSA, Sada and ILCP on the card for
   dna-p001 at scale 12.8 (n ~ 16.4M, d = 1,280); ``plan_queries`` and
   ``ilcp_list_docs_da_planned`` on 1,024 patterns in batches of 128.
3b. Primitives on the large index: ``wm_rank_batch`` on the CSA's wavelet
   for the patterns' symbols and positions (plus edge positions) against a
   host count over the BWT, one rank launch per level; the kernel-routed
   ``ilcp_list_docs_da_batch`` against the fused listing kernel bit for bit,
   one RMQ launch per lockstep iteration (counted by a host replay).
4. Kernels against their plain PyTorch versions on the card, on the real
   index arrays of phases 2 and 3 and on edge inputs: outputs must be
   bit-identical.  The PDL gather on phase 2's listing PDL and phase 2b's
   top-k PDL at max_buf 4,096 and 64 and max_cover 1,024 and 4 (window,
   expansion and cover truncation must all occur), each count held to a
   host replay of the cover.  ``pdl_list_docs_batch``,
   ``pdl_doc_freqs_batch`` and ``ilcp_list_docs_da_planned`` run once each
   under ``torch.cuda.set_sync_debug_mode("error")``.  Times with CUDA
   events after a warm-up; device times by CUDA events around calls queued
   behind a spin kernel, the profiler's beside them (it drops the device
   events of some windows); rank and RMQ also on one stream of 2^22
   queries; beside them one empty kernel's device time, the launch floor.
   Bounds: bytes over the memory rate, and a latency bound, the dependent
   global reads on the slowest query's path through the kernel, each round
   at one dependent load's latency: an L1 hit's where the path (for the
   PDL gather, its block in an earlier phase) read the line before, else
   an L2 hit's, both measured by the probe (16 KB and 16 MB cycles; a 256
   MB one beside them).  The PDL gather's path is its block's: per chunk
   of 256 leaves the longest climb, the chain's links and the list sizes,
   per expansion phase (four chunks' members) the longest member's
   expansion; its slowest query's cover is printed.
4b. The serving runtime on the services of phases 2 and 2b (no new
   build): ``ServeRuntime`` with the serving CLI's settings (batches of 32,
   k = 10, 0.5 s deadlines), 256 requests per mode (``list`` and ``count``
   on phase 2's service, ``topk`` and ``tfidf`` on phase 2b's) drawn from
   the occ/df workload, after two warm passes over the same batches.  Clean
   traffic: every answer ``full`` and equal to the direct endpoint call,
   no degradation, retry, failure, short circuit or deadline miss, and
   each batch exactly one replay's launches of its programs.  The same
   requests under seeded ``executor_fail:0.2, executor_poison:0.2,
   slow_list, compile_error``, then each rung forced once per mode (the
   full path failing every attempt, with and without the floor): every
   request answered, no ``POISON``, each degraded answer flagged
   ``cause:path``, the reference rung equal to the full path, the floor
   equal to the endpoint with the floor's arguments.  ``engine="reference"``
   (``list_docs`` auto/brute/ilcp/pdl, ``count``, ``topk``, ``tfidf``) on a
   batch of 32 bit-identical to the graph programs, with its launches (1
   backward search per range pass, 1 ILCP listing or PDL gather per query
   that takes one) and time per batch.  Validation: both builds'
   ``build_seconds["validate"]``, a flipped wavelet word and a flipped DA
   entry rejected.  Then ``python -m repro_torch.launch.serve`` twice as
   subprocesses: clean ``--mode topk`` (no degradation, no retry) and
   ``--mode list --inject executor_fail:0.2,slow_list`` (every query
   served); both runs' steady p50/p99 lines are printed.
5. LM serving: llama3.2-3b at full width and depth (28 x 3,072, 3.6B
   parameters, bf16, seeded random weights), ``attention_impl="flash"``.
   (a) 4 prompts of 2,048 tokens: one ``forward_prefill`` into a cache of
   2,080 positions, then 32 greedy ``forward_decode`` steps; (b) 1 prompt of
   32,768 tokens (the registry's ``prefill_32k`` length at batch 1), then 8
   steps.  28 flash launches per prefill, all on the Hopper kernel (TMA,
   ``wgmma``, split P), none per decode step; the bf16 last-token logits
   of the same prompts through the SIMT kernel, their gap reported.  Checks
   off the kernel path, in f32 at the same width on 1 x 2,048 tokens (the
   SIMT kernel): the flash path's logits against the ``"xla"`` path's, and
   4 decode steps against ``forward_prefill`` of the tokens so far.  Then
   both flash kernels against the plain version on layer 0's q/k/v of (a)
   and (b) and on edge shapes (head dims 16/64/128, ragged S, S_kv > S_q,
   full attention, GQA, a misaligned view that only the SIMT kernel
   takes), timed beside ``scaled_dot_product_attention`` as a yardstick.
6. Embedding bag on a 39,979,771 x 128 table (the largest MLPerf DLRM
   table, 20.5 GB in f32, then in bf16): bags of B = 65,536 and 512, one
   index each and 1..32 indices padded to 32, ``sum`` and ``mean``; then
   narrow bf16 tables of the same rows at D = 1, 10, 16 and 50 (the recsys
   row widths) at 262,144 x 39 uniform ids as bags of one (``sum``); each
   against the plain version (bags of one also bit for bit against
   ``table[ids]``), and timed beside ``torch.nn.functional.embedding_bag``
   (and, for bags of one, ``table[ids]`` and ``torch.index_select``) as
   yardsticks, with the byte bound and the sector bound.

7. The paper's baselines (after phase 4b, on the indexes of phases 2 and 3;
   no new service build, at most 60 s): C's sparse-table RMQ and the DA
   wavelet matrix built on the card for phase 2's collection; Brute-D,
   Sada-C-D and Sada-C-L (``sada_c_list``, on a stored DA and on the CSA
   locate), Sada-I-D and Sada-I-L (``ilcp_list`` on both DA sources), WT
   (``wt_list``) and ``wt_topk`` (k = 10) on phase 2's 128 patterns in
   batches of 32 at ``max_df = d + 1`` (``doc_listing.py``'s setting), one
   launch of each kernel per batch and call; every row held to the host
   oracle (distinct DA[lo:hi], with frequencies for Brute-D and WT), also
   on an edge batch at ``max_df = 4`` that truncates.  Each new kernel
   against its plain version bit for bit on one batch of 32 and on masked
   (0, 0) rows with (0, n), and against a host replay of its recursion;
   ms, device ms, byte bound, latency bound (the slowest query's dependent
   read rounds, replayed on the host, at the probe's L2 latency), floor +
   latency and plain ms; each structure's modeled bits per char.  Then
   Sada's five encodings (``plain``, ``rle``, ``sparse``,
   ``sparse_sparse``, ``filter_plain``) built on the card for phase 2's
   index and phase 3's (n = 16,385,280): on the same ranges every df
   equals the sparse variant's, the ILCP count and the oracle; bits per
   char and count time per batch.
8. The docs-sharded service (after phase 7, on the collections and
   batches of phases 2 and 2b): ``RetrievalService.build(mesh=...)`` with
   4 document shards on the card.  8a: phase 2's collection (shards of
   80 documents, no top-k PDL): ``plan``, ``count``, ``count`` with an
   unknown engine name (df, as the reference), ``list_docs`` (auto, ilcp,
   brute, pdl, and auto with a pinned window) at ``max_df = d + 1`` and a
   buffer above every occ, so that no row truncates.  8b: phase 2b's
   collection (both PDLs): ``topk`` (k = 10, the five cases of phase 2b)
   and ``tfidf`` (or, and) on its batches.  Every answer equal to the flat
   service's on the same batches (tf-idf scores bit for bit); each call's
   launches one replay of each program times the shards (plus a warm-up
   where it captured), no rank or RMQ launch; the answers bit-identical
   to the sharded programs run eagerly; one capture per (kind, bucket);
   every sharded program run eagerly under
   ``set_sync_debug_mode("error")``.  Per-batch p50 of each endpoint,
   sharded beside flat, in turns; build seconds per shard;
   ``validate_sharded_service`` seconds and a tampered shard rejected; a
   short clean ``ServeRuntime`` pass (list, count) over 8a's service.
   Then ``tfidf_topk_incremental`` on 32 two-term queries of phase 2b's
   flat service (or, and): documents and scores equal to the same call
   on a CPU copy of the index, one PDL gather launch per term.
9. The analysis gate (after phase 8, on phase 2's service, under a
   minute): ``audit_service`` and ``audit_sharded_service``
   (``repro_torch.analysis.contracts``) on the gate's audit collection,
   flat and as 4 shards on the card, at buckets (1, 8) and (8, 8), and
   ``audit_service`` on phase 2's service at (32, 8) with its ``max_df``
   and ``max_buf`` (``plan`` and ``list``: no top-k PDL there).  Every
   program runs once recorded and is captured into a debug-mode CUDA
   graph: every contract clean, the graph's kernel nodes of the port's
   kernels equal to the recorded calls, each program's nodes printed, and
   those of phase 2's ``list`` program at its automatic Brute-L window
   beside the audited pinned one.  A seeded contract (two backward
   searches per ``plan``) must give exactly one ``launches`` violation, a
   ``plan`` program with a second, unrecorded backward search exactly one
   ``graph_kernels`` violation, and ``python -m repro_torch.analysis`` as
   a subprocess must exit 0.
10. LM training (after phase 6): smollm-135m at full width and depth (30 x
   576, 9 heads over 3 KV heads, Dh 64, vocab 49,152, tied embeddings,
   134.5M parameters), bf16, seeded random weights,
   ``attention_impl="flash"``.  (a) 8 AdamW steps through ``train`` on 4 x
   4,096 tokens a step from ``lm_batches`` (the registry's ``train_4k``
   length; its batch of 256 cut to 4), checkpoints at steps 4 and 8:
   finite losses, exactly 60 flash launches per step, all on the Hopper
   kernel (30 in the forward, 30 when the checkpointed groups recompute in
   the backward), and step 1's batch scoring lower with step 8's
   checkpoint than at step 1.  One step profiled: wall, device time, busy
   share, the flash forward per launch, the top kernels.  A full-width
   checkpoint round trip bit for bit.  (c) ``train_with_recovery`` with a
   failure injected at step 6 resumes from step 4's checkpoint and ends at
   step 8, its losses equal to (a)'s; the same 8 steps with
   ``compress_grads=True``.  (b) The Function's dq/dk/dv on layer 0's q/k/v
   of (a) against autograd through ``flash_attention_plain``, and
   ``flash_attention_vjp``'s time per layer; in f32 at full width on 1 x
   2,048 tokens, the flash step (SIMT kernel) against the ``"xla"`` step,
   plain autograd: the loss and every gradient leaf, ``wq``, ``wk`` and
   ``wv`` included.  (d) ``python -m repro_torch.launch.train --arch
   smollm-135m --steps 20`` as a subprocess, exit 0.

11. Llama 4 serving (after phase 10): llama4-scout-17b-a16e at full width
   (d_model 5,120, 40 heads over 8 KV heads x 128, 16 experts of d_ff
   8,192 with top-1 routing plus the shared expert, vocab 202,048, chunks
   of 8,192 on the three local layers of each group of four, the fourth
   global and NoPE), its depth cut from 48 to 8 layers (two groups; 19.7B
   parameters, 39.4 GB in bf16), bf16, seeded random weights,
   ``attention_impl="flash"``.  (a) One ``forward_prefill`` of 1 x 16,384
   tokens (two chunks on each local layer) into a cache of 16,400, then
   16 greedy ``forward_decode`` steps (the first opens a new local chunk);
   (b) 4 x 8,192 tokens (T = 32,768, capacity 2,560), then 8 steps.  Each:
   exactly 8 flash launches per prefill, all on the Hopper kernel, none per
   decode step; prefill s and tokens/s, the decode median, peak memory and
   the tokens each MoE layer's capacity dropped.  One prefill of (a)
   profiled: wall, device time, busy share and device time by class
   (flash, GEMMs, MoE sort, scatter/gather, the rest).  (d) The Hopper
   kernel against the plain version on layer 0's chunked-local q/k/v
   ([2, 40, 8,192, 128] views) and layer 3's global q/k/v ([1, 40, 16,384,
   128]) of (a), within 2 bf16 ulps, timed beside SDPA.  (c) In f32 at
   full width, one group (4 layers, 43.5 GB of weights, made after (a) and
   (b)'s are freed), 1 x 16,384 tokens: the flash path (the SIMT kernel)
   against the ``"xla"`` path, the routing of every MoE layer first (each
   token's expert and whether it is kept, equal; a differing token is
   reported with its top-2 gate margin), then the last-token logits within
   1e-3; then 4 decode steps after an 8,188-token prefill against
   ``forward_prefill`` of 8,189 .. 8,192 tokens (one chunk), with the
   capacity factor at E so that no prefill drops a token (decode never
   drops one: the reference's ``S == 1`` branch).  (e) ``python -m
   repro_torch.launch.train --arch llama4-scout-17b-a16e --steps 20`` as a
   subprocess, exit 0.

12. RecSys (after phase 11, at most 150 s): FM (39 fields x 10), SASRec
   (1,000,000 items x 50, 2 blocks, sequences of 50), AutoInt (39 x 16, 3
   layers, 2 heads, d_attn 32) and DLRM-MLPerf (26 tables of 187,767,399
   rows x 128, MLPs 13-512-256-128 and 1024-1024-512-256-1) at their
   published widths, seeded random weights; every row lookup is one
   embedding-bag launch with bags of one.  (a) Serving, in the registry's
   serving copy (2-D leaves of 65,536 rows or more in bf16, the rest f32;
   every leaf drawn in bf16, so DLRM's 187,767,808 x 128 table is 48.07 GB):
   ``serve_p99`` (512 rows) and ``serve_bulk`` (262,144) through
   ``*_logits`` / ``sasrec_serve``, ``retrieval_cand`` (one user against
   1,000,000 candidates of the largest field, SASRec: of the items; AutoInt
   in 4 calls of 250,000 and DLRM in 2 of 500,000, to keep the activations
   under the card's memory): ms (median of warm calls), rows/s, peak
   memory, and the embedding-bag launches of every call (FM 2 a batch, 4 a
   retrieval; SASRec 2, 2; AutoInt 1, 2; DLRM 1, 2); each lookup of the
   batches and candidates against ``table[ids]`` bit for bit (with the
   tables' last rows); the first 1,024 retrieval scores against the
   scoring entry point on the same user with each candidate filled in; the
   lookup alone at the bulk batch's ids on each big table, beside
   ``table[ids]``, ``torch.index_select`` on the int32 ids,
   ``F.embedding_bag`` and the plain version, with the byte and sector
   bounds.  (b)
   Training in f32: 8 AdamW steps through ``train`` on 65,536 rows a step
   (the registry's ``train_batch``), DLRM with each table capped at
   1,048,576 rows (7,402,496 rows, 3.79 GB: the functional AdamW update
   holds about 12 table-sized buffers at its peak): the launches of every
   step (FM 2, SASRec 3, AutoInt 1, DLRM 1), finite losses, step s (median
   of steps 2-8), rows/s, peak memory; the f32 lookups bit for bit; on
   FM's first batch the tables' gradients through the kernel (its
   scatter-add accumulated in f64) against an f64 gradient, beside plain
   f32 ``table[ids]`` autograd's distance from it.  (c) ``python -m repro_torch.launch.train
   --arch dlrm-mlperf --steps 20`` and ``--arch sasrec --steps 20`` as
   subprocesses, exit 0.

13. NequIP (after phase 12, about 80 s): 5 interaction layers, 32 channels,
   l_max 2, 8 radial functions, cutoff 5, seeded random weights, f32, on
   the registry's GNN shapes with graphs from ``random_graph``:
   ``full_graph_sm`` (2,708 nodes, 10,556 edges, 1,433 features),
   ``molecule`` (3,840 nodes, 8,192 edges, 32 features, 128 graphs) and
   ``minibatch_lg`` (169,984 nodes and edges, 602 features, 4 edge chunks;
   dense on one card, where the reference partitions it over its mesh).
   On each: ``forward_energy`` timed, 8 AdamW steps of ``forward_train``
   through ``train`` (step s, nodes/s, peak memory, finite losses), one
   step profiled (device ms by class), beside the registry cell's one-card
   roofline terms.  Checks: on ``full_graph_sm`` and ``molecule`` the
   card's energies and loss against the port's CPU run in f64 of the same
   parameters and graph; on all three, the energies under a random
   rotation of ``edge_vec`` and the l = 1 features against v R^T;
   ``minibatch_lg``'s energies at 1 and 4 edge chunks.  ``ogb_products``
   (2,449,408 nodes, 61,865,984 edges, 100 features): the host seconds of
   ``random_graph``, ``build_csr`` and ``neighbor_sample`` (1,024 seeds,
   fanout 15-10), then ``forward_energy`` at full size under ``no_grad``
   in the fewest edge chunks that fit (printed), its seconds and peak
   memory (training there needs the partitioned step, A12.2b).  Then
   ``python -m repro_torch.launch.train --arch nequip --steps 3 --device
   cuda`` as a subprocess, exit 0.  No kernel of the port runs in this
   phase, so the kernel line does not change.

14. Several ranks on one card (after phase 13, about 140 s):
   ``launch.mesh.spawn_ranks`` starts one process a rank on ``cuda:0``
   (start method ``spawn``, the kernels already built by phase 1, so the
   ranks only load them).  (a) llama4-scout-17b-a16e at full width, one
   group (3 local + 1 global layers), bf16, flash attention, capacity
   factor E (no token dropped), on a (data 1, model 2) mesh over gloo:
   each rank draws its 8 experts a layer (every leaf and expert from a
   seed of its own), takes 2 expert-parallel loss-and-gradient steps on
   1 x 4,096 tokens (the most that fit: two ranks of 33 GiB peaks), the
   second with its collectives timed (host staging under gloo); exactly
   8 flash launches a rank a step, all on the Hopper kernel; finite
   gradients; the same loss on both ranks, within 2e-3 of the local
   dispatch's on the same weights and tokens in one process after the
   ranks exit.  No AdamW step: its f32 moments do not fit (the reason is
   printed).  (d) The same step on a 1-rank NCCL group (16 experts),
   NCCL's path launched on the card: its launches, finite gradients, the
   loss against the local dispatch's.  (b) and (c) in one world of 4
   ranks on a (2, 2) mesh over gloo: (b) the reduced Scout in f32,
   ``ep_fsdp`` off and on, every gradient leaf on the card against the
   same ranks on the CPU, within 1e-5 of the leaf's max |value|; (c)
   NequIP ``minibatch_lg`` partitioned by ``build_partition`` over the 4
   ranks in f32: the loss and summed gradient against the dense one-card
   step on the same graph and weights, 8 partitioned AdamW steps with
   finite losses, step seconds, and the halo bytes a layer beside the
   reference's |halo| x C x 13 x 4, the forward's collective bytes
   checked against it exactly, and each step's bytes a rank against
   ``dist.roofline.gnn_bytes``.  Every rank failure fails the run.
15. The registry's layout as per-rank programs (after phase 14, within
   150 s; ``dist.tp``, ``models.recsys.RowBlock``), ranks on ``cuda:0``
   over gloo.  (a) llama3.2-3b at full width, bf16, flash attention, cut
   to 4 of its 28 layers, in the ``train_4k`` cell's ``in_specs`` on a
   (data 2, model 2) mesh (FSDP on, as the registry's rule decides it for
   the full config): each rank draws its blocks of the seeded weights,
   takes 2 ZeRO-1 steps of 1 x 2,048 tokens a data shard (the second with
   its collectives timed: host staging under gloo); every rank's blocks of
   the cell's shapes, exactly 2 Hopper flash launches a layer a rank a
   step, the same loss on every rank, the bytes each rank sent equal to
   ``dist.roofline.tp_train_bytes``; then the same layers in f32 (TF32
   off) at 1 x 256 a shard, the loss and every gradient block within 1e-5
   of the largest magnitude of the one-rank ``forward_train`` and gradient
   on the same card.  (b) The same config at its full 28 layers in the
   ``prefill_32k`` cell's layout on (data 1, model 2): a 1 x 4,096 prefill
   (28 Hopper flash launches a rank) and 8 greedy decode steps (none; the
   argmax over the gathered vocab, the same token on both ranks), the
   prefill's bytes a rank equal to ``dist.roofline.tp_prefill_bytes`` and
   each decode step's to ``tp_decode_bytes``, then an f32 prefill and
   decode step at 4 layers whose logits and cache blocks lie within 1e-4
   of the one-rank ones.  (c) FM, SASRec, AutoInt and
   DLRM-MLPerf at their published widths, the serving copy (bf16 tables),
   on (data 1, model 2) through the registry's ``serve_p99`` (512) and
   ``serve_bulk`` (262,144) cells: the one-rank scores first (DLRM's
   48 GB table whole), freed before the ranks start; each rank draws its
   rows of every big table alone (DLRM: 24 GB a rank, seeded by chunks of
   2^20 rows); scores bit for bit the one-rank ones, one embedding-bag
   launch a lookup a rank, each call's bytes a rank equal to
   ``dist.roofline.recsys_bytes``.  Prints step seconds, the host-staging share,
   the bytes each rank sent beside the formula and peak memory a rank.

Prints one JSON line of kernel records, then the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.

Tolerances of the kernel checks: the seven index kernels (nine
instantiations) are bit-identical to their plain versions.  Flash attention in f32 within 2e-5 and embedding
bag in f32 within 1e-6 (the reference's own kernel tests); in bf16 both
within 2 bf16 ulps of the plain version (they compute in f32, the Hopper
flash kernel with P split into two bf16 parts, and round once; ulps are
counted at each element's magnitude, floored at 2^-8 of the tensor's
largest).  The LM checks hold f32 logits within 1e-3 (summation
order through 28 layers; logits reach about 5).  Training (phase 10): the
f32 flash step's loss within 1e-4 relative of the "xla" step's and every
gradient leaf within 1e-3 in relative norm (summation order; a dropped
attention gradient is off by order 1); the Function's bf16 dq/dk/dv within
2 bf16 ulps of autograd through the plain version (both in f32, one
rounding each); the resumed run's losses within 1e-2 of the uninterrupted
run's (bf16 steps whose sums may run in another order, the embedding
gradient's accumulation among them); compressed against uncompressed
training, the mean of the last 4 losses within 0.25, the reference's own
parity bound.  RecSys (phase 12): lookups bit for bit; retrieval scores
within 2^-6 (4 bf16 ulps) of the largest score of the scoring entry
point's (their bf16 sums are grouped otherwise: the reference's own gap
at reduced width is at most 3.5e-3 of it, tests/test_torch_recsys.py,
and FM's at full width, 39 fields summed in bf16, about 1.1e-2); FM's
table gradients through the kernel within 1e-6 in relative norm of an
f64 gradient (plain f32 autograd's own sums lie 2.2e-6 from it on the
embedding table).  NequIP (phase 13): node features (s invariant and v
against v R^T under a rotation; s at 1 against 4 edge chunks) within 1e-5
of their largest magnitude (f32 rounding and the order of ``index_add_``,
whose atomics add in any order on the card, and of the einsums); energies
(against the CPU's f64 run, under the rotation, at 1 chunk) within 1e-5 +
8 x 2^-24 sqrt(n) of the largest |energy|, n the nodes a graph sums (the
f32 sum's own rounding walk: 2.1e-4 at minibatch_lg's 169,984), and the
loss within twice that, relative.  Several ranks (phase 14): the
expert-parallel bf16 loss within 2e-3 relative of the local dispatch's
(the same products in another grouping); the f32 expert-parallel
gradient, card against CPU, within 1e-5 of each leaf's max |value|; the
partitioned NequIP loss within phase 13's loss bound of the dense one's
(both f32 sums of 169,984 node energies in different orders; the dense
loss in f64 is printed beside them) and its summed gradient within 1e-4
of each leaf's max |value|.  The registry's layout (phase 15): the f32
tensor-parallel, FSDP and ZeRO-1 loss and gradient within 1e-5 of each
leaf's max |value| of the one-rank step's (the products' and the sums over
ranks' order, as ``tests/test_torch_tp.py`` holds them to the reference);
the f32 prefill and decode within 1e-4 (phase 5's gate); row-sharded
recsys scores bit for bit (one row and zeros summed in f32).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and the non-tensor-core
# 32-bit rate, taken here for the kernels' int32 ALU operations.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12   # dense tensor-core rate
F32_FLOPS_PER_S = 67e12     # outside the tensor cores

MAX_DF = 256
MAX_BUF = 4096
FULL_SCALE = 3.2     # dna-p001 at n = 1,024,320, with the listing PDL
TOPK_SCALE = 1.6     # dna-p001 at n = 256,160, with both PDLs
LARGE_SCALE = 12.8   # dna-p001 at n ~ 16.4M, no PDL
LARGE_QUERIES = 1024
TOPK_K = 10
TFIDF_MAX_BUF = 2048   # the serving CLI's tf-idf buffer (max_terms = 4)
STREAM_Q = 1 << 22     # queries of the rank/RMQ stream timings
LM_REQUESTS = (4, 2048, 32)   # prompts, prompt tokens, greedy decode steps
LM_LONG = (1, 32768, 8)       # the registry's prefill_32k length at batch 1
LM_CHECK_TOKENS = 2048        # f32 checks on 1 x 2,048 tokens
LM_CHECK_STEPS = 4
LM_F32_TOL = 1e-3
TRAIN_BATCH = (4, 4096)       # the registry's train_4k length; its batch of 256 cut to 4
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_AT = 6             # the recovery run's injected failure
TRAIN_CHECK_TOKENS = 2048     # the f32 gradient check on 1 x 2,048 tokens
TRAIN_LOSS_RTOL = 1e-4        # f32 flash step's loss against the "xla" step's
TRAIN_GRAD_RTOL = 1e-3        # each gradient leaf, in relative Frobenius norm
TRAIN_RESUME_TOL = 1e-2       # resumed bf16 losses against the uninterrupted run's
TRAIN_PARITY_BOUND = 0.25     # compressed against uncompressed (the reference's bound)
TRAIN_CLI_STEPS = 20
TRAIN_CLI_ARGS = ()           # extra flags of the training CLI's run
L4_LAYERS = 8                 # llama4-scout's 48 layers cut to two groups
L4_RUNS = {"long": (1, 16384, 16), "batch": (4, 8192, 8)}  # prompts, tokens, decode steps
L4_CHECK_TOKENS = 16384       # (c) f32 flash against "xla", one group
L4_DECODE_CHECK = (8188, 4)   # (c) prompt and decode steps, all in one chunk
L4_CLI_STEPS = 20
FLASH_F32_TOL = 2e-5
BAG_F32_TOL = 1e-6
BF16_ULPS = 2
EMB_ROWS = 39_979_771         # MLPERF_TABLE_SIZES' largest (repro.models.recsys)
EMB_DIM = 128
EMB_BATCHES = (65_536, 512)   # the registry's train_batch and serve_p99
EMB_LENGTHS = (1, 32)         # single-hot, and 1..32 indices padded to 32
EMB_NARROW_DIMS = (1, 10, 16, 50)  # the recsys tables' widths (FM, AutoInt, SASRec)
EMB_LOOKUP_IDS = 262_144 * 39      # the registry's serve_bulk batch x Criteo's 39 fields


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def queued_time_ms(fn, reps: int, spin_cycles: int = 20_000_000) -> float:
    """Device milliseconds per call by CUDA events around ``reps`` calls
    that the host enqueued while the card was held busy by a spin kernel
    (about 10 ms), so no host launch gap lies between the events.  For
    kernel wrappers, which never wait on the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_calls(fn, reps: int, warm: bool = True):
    """Run ``fn`` ``reps`` times under torch.profiler (after one call
    outside it, with ``warm``): per call, the wall milliseconds, the device
    milliseconds summed over every kernel (and copy), the device
    activities, and the device milliseconds by kernel name.  Reads the raw
    Kineto events (nanosecond durations) and skips the profiler's slow
    per-event Python post-processing."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    by_name, launches = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6 / reps
            launches += 1
    return {"wall_ms": wall, "device_ms": sum(by_name.values()) if by_name else None,
            "kernels_per_call": launches / reps, "by_kernel_ms": by_name}


def device_ms_of(prof: dict, substr: str):
    """Device milliseconds per call of the kernels whose name holds
    ``substr``; None where the profiler saw no device time."""
    hits = [v for k, v in prof["by_kernel_ms"].items() if substr in k]
    if not hits:
        log(f"[profile] no device kernel named *{substr}*; saw "
            + "; ".join(f"{k[:80]} {v:.4f}" for k, v in prof["by_kernel_ms"].items()))
    return sum(hits) if hits else None


def ceil_log2(x: int) -> int:
    """Binary-search probes over x entries."""
    return max(0, (int(x) - 1).bit_length())


class Chain:
    """The dependent global reads on one query's path through a kernel, in
    rounds: the reads of a round are issued together, and the round waits
    for them.  A round costs one L1 hit's latency when every 128-byte line
    it reads (keys: array name and line) was read earlier on the same path
    or is in ``seen`` (lines its block read in an earlier phase), else one
    L2 hit's: the path's latency bound is ``ns(lat)``."""

    def __init__(self, seen=frozenset()):
        self.lines, self.seen, self.l2, self.l1, self.reads = set(), seen, 0, 0, 0

    def read(self, *keys):
        self.reads += len(keys)
        fresh = any(k not in self.lines and k not in self.seen for k in keys)
        self.lines.update(keys)
        self.l2 += fresh
        self.l1 += not fresh

    def search(self, name, arr, x, right=False):
        """``rt::lower_bound`` (``upper_bound`` with ``right``) over
        int32 ``arr``, one round per probe."""
        lo, hi = 0, len(arr)
        while lo < hi:
            mid = (lo + hi) >> 1
            self.read((name, mid >> 5))
            if arr[mid] < x or (right and arr[mid] == x):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def group_search(self, name, arr, x, lanes=16):
        """``rt::group_search`` (lower bound) over int32 ``arr`` by
        ``lanes`` lanes: one round per ballot, its pivots read together.
        (index, arr[index], None when the index is len(arr))."""
        lo, hi, at = 0, len(arr), None
        while lo < hi:
            span = hi - lo
            piv = ([lo + t for t in range(span)] if span <= lanes else
                   [lo + ((t + 1) * span >> (lanes.bit_length() - 1)) for t in range(lanes - 1)])
            p = len(piv)
            self.read(*((name, q >> 5) for q in piv))
            c = sum(1 for q in piv if arr[q] < x)
            next_lo = piv[c - 1] + 1 if c else lo
            if c < p:
                hi, at = piv[c], int(arr[piv[c]])
            lo = next_lo
        return lo, at

    def ns(self, lat):
        return self.l2 * lat["l2_ns"] + self.l1 * lat["l1_ns"]


def longest(chains, lat):
    """The slowest path of a batch: (latency bound in ms, its rounds)."""
    c = max(chains, key=lambda x: x.ns(lat))
    return c.ns(lat) * 1e-6, {"l2_rounds": c.l2, "l1_rounds": c.l1}


def require(ok, msg="check failed"):
    """A check that stays in force under ``python -O``."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def reset_counts(kernels):
    for k in kernels:
        k.launches = 0


# ---------------------------------------------------------------------------
# Endpoint calls through the program cache (phases 2 and 2b)
# ---------------------------------------------------------------------------

#: launches of one replay of each endpoint program, per kernel
REPLAY_LAUNCHES = {
    "plan": {"backward_search": 1},
    "list": {"backward_search": 1, "ilcp_list": 1, "pdl_gather": 1},
    "topk": {"backward_search": 1, "pdl_gather": 1},
    "tfidf": {"backward_search": 1, "pdl_gather": 1},
}


@contextlib.contextmanager
def uncounted(kernels):
    """Launches inside the block (the eager comparisons) stay out of the
    wrappers' counts."""
    saved = [k.launches for k in kernels]
    try:
        yield
    finally:
        for k, n in zip(kernels, saved):
            k.launches = n


def checked_call(svc, kernels, kinds, name, fns, lat, warm, replay=REPLAY_LAUNCHES):
    """One endpoint call through the service's program cache, then
    (uncounted) the same work eagerly; ``fns`` is (graph call, eager call).
    The kernels must have counted one replay's launches of each program in
    ``kinds``, and once more for each program the call captured (its
    warm-up run; the capture launches nothing); the answers must be
    bit-identical.  Appends the host seconds to ``lat[name]`` and counts the
    call in ``warm[name]`` when it captured nothing.  ``replay``: the
    launches of one replay per kind (the sharded service's are the flat
    ones times the shards)."""
    graph_fn, eager_fn = fns
    before = [k.launches for k in kernels]
    tally = dict(svc.compile_counts)
    t = time.perf_counter()
    out = graph_fn()
    lat.setdefault(name, []).append(time.perf_counter() - t)
    new = {kind: svc.compile_counts.get(kind, 0) - tally.get(kind, 0) for kind in kinds}
    want = tuple(sum(replay[kind].get(k.__name__, 0) * (1 + new[kind])
                     for kind in kinds) for k in kernels)
    delta = tuple(k.launches - b for k, b in zip(kernels, before))
    require(delta == want, (name, "launches", delta, "want", want, "captured", new))
    require(sum(svc.compile_counts.values()) == sum(tally.values()) + sum(new.values()),
            (name, "captured a program of another kind", tally, svc.compile_counts))
    warm[name] = warm.get(name, 0) + (sum(new.values()) == 0)
    with uncounted(kernels):
        expected = eager_fn()
    require(same_bits(out, expected), (name, "graph answer differs from the eager one"))
    return out


def eager_endpoint(svc, kind, batch, engine="auto", max_df=None, k=None, max_buf=None,
                   conjunctive=False, max_terms=4):
    """What the endpoint computes, run eagerly (the program functions, no
    cache) on the same padded batch with the Brute-L window of the
    service's last call of that bucket, and the window's plan pass where
    the window is automatic: host arrays as the endpoint returns them."""
    from repro_torch.serve import retrieval as R
    from repro_torch.serve.planner import plan_queries

    if kind == "tfidf":
        pats, lens = svc._pad_terms(batch, max_terms)
        docs, scores = R._tfidf_program(k, conjunctive, max_buf, svc.csa, svc.pdl_topk,
                                        svc.sada, pats, lens)
        return docs[:len(batch)].cpu().numpy(), scores[:len(batch)].cpu().numpy()
    pats, lens, B = svc._pad_batch(batch)
    knobs = svc._knobs(engine)

    def plan_pass():
        plan = plan_queries(svc.csa, svc.sada, pats, lens, *knobs)
        return {n: getattr(plan, n)[:B].cpu().numpy() for n in ("lo", "hi", "occ", "df", "engine")}

    if kind == "plan":
        return plan_pass()
    key = (tuple(pats.shape), max_df, max_buf) if kind == "list" else \
        (tuple(pats.shape), k, max_buf)
    if svc.brute_window is None:
        plan_pass()
        win = svc._brute_windows[(kind, key)]
    else:
        win = min(svc.brute_window, max_buf)
    if kind == "list":
        docs, cnt, _ = R._list_program(max_df, win, max_buf, svc.csa, svc.ilcp, svc.pdl_list,
                                       svc.da, svc.sada, pats, lens, *knobs)
    else:
        docs, cnt, _ = R._topk_program(k, svc._topk_max_df(max_buf), win, max_buf, svc.csa,
                                       svc.pdl_topk, svc.sada, pats, lens, *knobs)
    return docs[:B].cpu().numpy(), cnt[:B].cpu().numpy()


def pinned(svc, fn, window=MAX_BUF):
    """``fn`` as a call made with the service's Brute-L window pinned to
    ``window``."""
    def run():
        svc.brute_window = window
        try:
            return fn()
        finally:
            svc.brute_window = None
    return run


def eager_count(svc, batch):
    return eager_endpoint(svc, "plan", batch)["df"]


def same_bits(a, b) -> bool:
    """Arrays (or tuples or dicts of them) equal in dtype, shape and bits."""
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_bits(a[x], b[x]) for x in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def graph_against_eager(svc, kernels, calls, label, rounds=3):
    """Per-batch host seconds of each endpoint call, graph replay and eager
    in turns on the same batches (``calls``: name -> list of (graph call,
    eager call) per batch), after the checked run; the graph calls are warm
    replays (checked: they capture nothing).  Logs min / median / max."""
    out = {}
    programs = sum(svc.compile_counts.values())
    for _ in range(rounds):
        for name, per_batch in calls.items():
            times = out.setdefault(name, {"graph": [], "eager": []})
            for graph_fn, eager_fn in per_batch:
                t = time.perf_counter()
                graph_fn()
                times["graph"].append(time.perf_counter() - t)
                with uncounted(kernels):
                    t = time.perf_counter()
                    eager_fn()
                    times["eager"].append(time.perf_counter() - t)
    require(sum(svc.compile_counts.values()) == programs, "a timed graph call captured")
    for name, times in out.items():
        g, e = np.asarray(times["graph"]), np.asarray(times["eager"])
        log(f"[{label}] {name} per batch, s: graph min {g.min():.5f} median {np.median(g):.5f} "
            f"max {g.max():.5f}; eager min {e.min():.5f} median {np.median(e):.5f} "
            f"max {e.max():.5f}; median ratio {np.median(e) / np.median(g):.2f}")


def log_programs(svc, label, replay=REPLAY_LAUNCHES):
    """compile_counts and each program's capture seconds, pool bytes and
    launches per replay; every program is a captured graph that launches
    its kind's kernels."""
    log(f"[{label}] compile_counts {svc.compile_counts}")
    for (kind, statics), prog in svc.compiled_programs().items():
        require(prog.graph is not None, (kind, statics, "not a captured graph"))
        require(prog.launches == replay[kind], (kind, statics, prog.launches))
        log(f"[{label}] program {kind} {statics}: capture {prog.capture_s:.4f} s, pool "
            f"{prog.pool_bytes} bytes, launches per replay {prog.launches}")


def profile_graph_and_eager(label, name, graph_fn, eager_fn, kernels, reps=5):
    """One warm batch under the profiler, graph and eager: wall, device ms,
    device activities and busy share (device over wall); the profiler
    slows the host, so also the median wall of ``reps`` unprofiled calls
    and the device ms over it."""
    for mode, fn in (("graph", graph_fn), ("eager", eager_fn)):
        with uncounted(kernels):
            prof = profile_calls(fn, 1)
            walls = []
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t) * 1e3)
        wall = float(np.median(walls))
        top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:3]
        dev_ms = prof["device_ms"]
        log(f"[{label}] {name} {mode} profile, last batch: wall {prof['wall_ms']:.3f} ms, "
            f"device {dev_ms} ms, {prof['kernels_per_call']:.0f} device activities, busy "
            f"{dev_ms / prof['wall_ms'] if dev_ms else None}; unprofiled wall {wall:.3f} ms, "
            f"device over it {dev_ms / wall if dev_ms else None}; top "
            + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top))


# ---------------------------------------------------------------------------
# Host replays: independent oracles that also count the work each query needs
# ---------------------------------------------------------------------------


def host_backward_search(words, prefix, zcount, base, pats, lens, n, sigma):
    """Per-query backward search in numpy: (lo, hi, active symbol steps of
    each query, each query's ``Chain``: its pattern row, then per active
    symbol one round per level reading both ends' word and prefix)."""
    words = words.view(np.uint32)
    levels = words.shape[0]

    def rank1(lvl, pos):
        w = pos >> 5
        mask = (1 << (pos & 31)) - 1
        return int(prefix[lvl, w]) + bin(int(words[lvl, w]) & mask).count("1")

    los, his, steps, chains = [], [], [], []
    for q, (row, m) in enumerate(zip(pats, lens)):
        lo, hi = 0, n
        steps.append(0)
        chains.append(Chain())
        chains[-1].read(("patterns", q))
        for t in range(int(m)):
            if lo >= hi:
                break
            steps[-1] += 1
            c = int(row[int(m) - 1 - t])
            if c < 0 or c >= sigma:
                lo = hi = 0 if c < 0 else n
                break
            for lvl in range(levels):
                chains[-1].read(*((a, lvl, pos >> 10) for a in ("words", "prefix")
                                  for pos in (lo, hi)))
                bit = (c >> (levels - 1 - lvl)) & 1
                r1p, r1q = rank1(lvl, lo), rank1(lvl, hi)
                lo = lo - r1p if bit == 0 else int(zcount[lvl]) + r1p
                hi = hi - r1q if bit == 0 else int(zcount[lvl]) + r1q
            lo += int(base[c])
            hi += int(base[c])
        los.append(lo)
        his.append(max(lo, hi))
    return np.asarray(los, np.int32), np.asarray(his, np.int32), steps, chains


def host_ilcp_list(vilcp, table, run_starts, da, lo, hi, d, max_df):
    """The Fig-1 recursion per query in Python (the reference's trajectory):
    (docs rows in discovery order, counts, pops, DA positions scanned, per
    query the iterations the batch-lockstep machine spends on it: one per
    pop, or one per DA position a pop's run visits, plus the one in which it
    finds nothing left to pop; and per query the ``Chain`` of the warp
    kernel: the root runs' binary searches and RMQ, then per pop of a valid
    interval its run_starts read and its DA reads, 32 positions a round, the
    children's RMQs issued beside them)."""
    levels, rho = table.shape
    cap, max_pops = max_df + 4, 2 * max_df + 8
    starts = run_starts[:-1]
    rows, cnts, pops_total, scanned, iters, chains = [], [], 0, 0, [], []
    for a0, b0 in zip(lo.tolist(), hi.tolist()):
        stack = [(int(np.searchsorted(starts, a0, "right")) - 1,
                  int(np.searchsorted(starts, b0 - 1, "right")) - 1)]
        seen, out, pops, steps = set(), [], 0, 1
        chain = Chain()
        if a0 < b0 and stack[0][0] <= stack[0][1]:
            chain.search("run_starts", starts, a0, right=True)
            chain.search("run_starts", starts, b0 - 1, right=True)
            a, b = min(max(stack[0][0], 0), rho - 1), min(max(stack[0][1], 0), rho - 1)
            k = min(max(int(np.floor(np.log2(max(b - a + 1, 1)))), 0), levels - 1)
            right = max(b - (1 << k) + 1, a)
            chain.read(("table", k, a >> 5), ("table", k, right >> 5))
            chain.read(("vilcp", int(table[k, a]) >> 5), ("vilcp", int(table[k, right]) >> 5))
        while stack and len(out) < max_df and pops < max_pops:
            a, b = stack.pop()
            pops += 1
            steps += 1
            if a > b or a0 >= b0:
                continue
            a, b = min(max(a, 0), rho - 1), min(max(b, 0), rho - 1)
            k = min(max(int(np.floor(np.log2(max(b - a + 1, 1)))), 0), levels - 1)
            ia, ib = int(table[k, a]), int(table[k, max(b - (1 << k) + 1, a)])
            r = ib if (vilcp[ib] < vilcp[ia] or (vilcp[ib] == vilcp[ia] and ib < ia)) else ia
            i, j = max(a0, int(run_starts[r])), min(b0, int(run_starts[r + 1]))
            chain.read(("run_starts", r >> 5), ("run_starts", (r + 1) >> 5))
            aborted, visits, k0 = False, 0, i
            while i < j and len(out) < max_df:
                if (i - k0) % 32 == 0:
                    chain.read(("da", i >> 5), ("da", min(i + 31, j - 1) >> 5))
                g = int(da[i])
                scanned += 1
                visits += 1
                i += 1
                if g in seen:
                    aborted = True
                    break
                seen.add(g)
                out.append(g)
            steps += max(visits, 1) - 1
            if aborted:
                continue
            if r + 1 <= b and len(stack) < cap:
                stack.append((r + 1, b))
            if a <= r - 1 and len(stack) < cap:
                stack.append((a, r - 1))
        pops_total += pops
        iters.append(steps)
        chains.append(chain)
        cnts.append(len(out))
        rows.append(out + [-1] * (max_df - len(out)))
    return (np.asarray(rows, np.int32).reshape(len(cnts), max_df),
            np.asarray(cnts, np.int32), pops_total, scanned, iters, chains)


def check_listing(docs, cnt, lo, hi, da, max_df, max_buf=None, sorted_rows=True):
    """Rows ascending (or distinct, for discovery order), -1 padded, a subset
    of DA[lo:hi]'s documents, and all of them when df <= max_df and occ is
    within the row's buffer.  ``max_buf``: None (no engine buffer bounds the
    rows) or, per row, the bound of the engine that ran it (None for ILCP)."""
    for r in range(len(cnt)):
        truth = set(da[lo[r]:hi[r]].tolist())
        row = docs[r, : cnt[r]].tolist()
        require(np.all(docs[r, cnt[r]:] == -1), (r, "padding"))
        if sorted_rows:
            require(row == sorted(set(row)), (r, "not ascending and distinct"))
        else:
            require(len(set(row)) == len(row), (r, "duplicate documents"))
        require(set(row) <= truth, (r, "document outside DA[lo:hi]"))
        buf = None if max_buf is None else max_buf[r]
        if len(truth) <= max_df and (buf is None or hi[r] - lo[r] <= buf):
            require(set(row) == truth, (r, "incomplete listing"))


def engine_buffers(codes, max_buf):
    """Per-row listing buffer: Brute-L's window and PDL's candidate buffer
    are bounded by ``max_buf``; the ILCP recursion reads no buffer."""
    from repro_torch.serve.planner import ENGINE_BRUTE, ENGINE_PDL

    return [max_buf if c in (ENGINE_BRUTE, ENGINE_PDL) else None for c in codes]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log(f"[build] {path.name} in {seconds:.2f} s")
    for line in _build.build_log.get("output", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[ptxas]", line.strip())
    report = _build.build_log.get("ptxas", {})
    flash = {kernel_label(k): v for k, v in report.items() if "flash" in k}
    log(f"[ptxas] flash kernels: {json.dumps(flash)}; warnings: {report.get('warnings')}")
    return {"kernels": flash, "warnings": report.get("warnings", []), "build_s": seconds}


def kernel_label(mangled: str) -> str:
    """``flash_hopper_kernel<128>`` or ``flash_attention_kernel<bf16,64>``
    for a mangled flash kernel name."""
    import re

    m = re.search(r"(?<=\d)(flash_[a-z_]*kernel)I(\w*?)EE", mangled)
    if not m:
        return mangled
    args = m.group(2).replace("13__nv_bfloat16", "bf16,").replace("Li", "")
    return f"{m.group(1)}<{'f32,' + args[1:] if args.startswith('f') else args}>"


def phase_full_path(dev, bs, il, pg):
    from repro_torch.core.suffix import build_suffix_data
    from repro_torch.data.collections import (
        generate, paperlike_collections, random_substring_patterns,
    )
    from repro_torch.serve.planner import ENGINE_CODES
    from repro_torch.serve.retrieval import RetrievalService

    coll = generate(paperlike_collections(scale=FULL_SCALE)["dna-p001"])
    log(f"[full] dna-p001 x{FULL_SCALE}: n={coll.n} d={coll.d} sigma={coll.sigma}")
    t0 = time.perf_counter()
    svc = RetrievalService.build(coll, block_size=64, beta=16.0, topk_index=False, device=dev)
    build_s = time.perf_counter() - t0
    log(f"[full] service build {build_s:.2f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in svc.build_seconds.items()))
    t0 = time.perf_counter()
    data = build_suffix_data(coll, dev)
    pats = random_substring_patterns(coll, 2000, 6, 128, data=data)
    log(f"[full] {len(pats)} patterns in {time.perf_counter() - t0:.2f} s")
    require(len(pats) >= 32, "workload generation produced too few patterns")
    require(torch.equal(svc.da, data.da))
    da = data.da.cpu().numpy()
    max_df = min(MAX_DF, coll.d + 1)

    kernels = (bs, il, pg)
    batches = [pats[i:i + 32] for i in range(0, len(pats), 32)]

    def endpoint_calls(batch):
        """(graph call, eager call) of each endpoint case on ``batch``."""
        calls = {
            "plan": (lambda: svc.plan(batch), lambda: eager_endpoint(svc, "plan", batch)),
            "count": (lambda: svc.count(batch), lambda: eager_count(svc, batch)),
        }
        for engine in ("auto", "ilcp", "brute", "pdl"):
            calls[f"list_docs[{engine}]"] = (
                lambda e=engine: svc.list_docs_arrays(batch, max_df=max_df, engine=e,
                                                      max_buf=MAX_BUF),
                lambda e=engine: eager_endpoint(svc, "list", batch, e, max_df,
                                                max_buf=MAX_BUF))
        calls["list_docs[auto,pinned]"] = (
            pinned(svc, lambda: svc.list_docs_arrays(batch, max_df=max_df, max_buf=MAX_BUF)),
            pinned(svc, lambda: eager_endpoint(svc, "list", batch, "auto", max_df,
                                               max_buf=MAX_BUF)))
        return calls

    per_batch = [endpoint_calls(b) for b in batches]
    lat, warm = {}, {}
    ilcp_nonempty = 0
    reset_counts(kernels)  # the main path's run starts here
    for batch, fns in zip(batches, per_batch):
        plan = checked_call(svc, kernels, ("plan",), "plan", fns["plan"], lat, warm)
        lo, hi = plan["lo"], plan["hi"]
        truth_df = np.asarray([len(set(da[a:b].tolist())) for a, b in zip(lo, hi)])
        require(np.all(hi - lo == plan["occ"]) and np.all(plan["occ"] > 0))
        require(np.array_equal(plan["df"], truth_df), "plan df != distinct docs of DA[lo:hi]")
        cnt = checked_call(svc, kernels, ("plan",), "count", fns["count"], lat, warm)
        require(np.array_equal(cnt, truth_df), "count != distinct docs of DA[lo:hi]")
        for engine in ("auto", "ilcp", "brute", "pdl"):
            name = f"list_docs[{engine}]"
            docs, c = checked_call(svc, kernels, ("plan", "list"), name, fns[name], lat, warm)
            require(docs.shape == (len(batch), max_df) and docs.dtype == np.int32)
            codes = plan["engine"] if engine == "auto" else [ENGINE_CODES[engine]] * len(c)
            check_listing(docs, c, lo, hi, da, max_df, engine_buffers(codes, MAX_BUF))
            if engine == "ilcp":
                ilcp_nonempty += int((c > 0).sum())
        docs, c = checked_call(svc, kernels, ("list",), "list_docs[auto,pinned]",
                               fns["list_docs[auto,pinned]"], lat, warm)
        check_listing(docs, c, lo, hi, da, max_df, engine_buffers(plan["engine"], MAX_BUF))
        lists = svc.list_docs(batch, max_df=max_df)
        require([len(x) for x in lists] == c.tolist())
    launches = {"backward_search": bs.launches, "ilcp_list": il.launches,
                "pdl_gather": pg.launches}
    require(all(v > 0 for v in launches.values()), launches)
    require(ilcp_nonempty > 0, "ilcp_list returned no documents under engine='ilcp'")
    require(all(n > 0 for n in warm.values()), ("an endpoint made no warm call", warm))
    log(f"[full] {len(batches)} batches of 32, launches {launches}; warm calls (replays "
        f"only) {warm}")
    log("[full] host seconds per batch, first pass (a capture where the bucket or its "
        "window was new): "
        + "; ".join(f"{k} " + " ".join(f"{x:.4f}" for x in v) for k, v in lat.items()))
    log_programs(svc, "full")

    graph_against_eager(svc, kernels, {name: [pb[name] for pb in per_batch]
                                       for name in per_batch[0]}, "full")
    # where a batch's time goes: device busy time against the host clock,
    # for the last batch under the automatic engine choice
    engines = svc.plan(batches[-1])["engine"]
    mix = {name: int((engines == code).sum())
           for name, code in (("brute", 1), ("ilcp", 2), ("pdl", 3))}
    profile_graph_and_eager("full", f"list_docs[auto] {mix}", *per_batch[-1]["list_docs[auto]"],
                            kernels)
    log(f"[full] space report {svc.space_report()}")
    return svc, batches, launches, data


def host_topk(da, lo, hi, k):
    """Top-k documents of DA[lo:hi] by (tf desc, id asc), and every
    document's tf."""
    docs, tf = np.unique(da[lo:hi], return_counts=True)
    order = np.lexsort((docs, -tf))
    return docs[order][:k], tf[order][:k], dict(zip(docs.tolist(), tf.tolist()))


def pdl_gather_entries(pdl, lo, hi, max_cover=1024):
    """Host replay of the PDL gather's cover of SA[lo, hi): the entries it
    takes (partial blocks one per position, each full cover node its stored
    list), whether ``max_cover`` cut the cover short, and the window
    entries.  The gather's count is the window entries where they fill the
    buffer, else min(entries, max_buf)."""
    L, ls = pdl["L"], pdl["leaf_starts"]
    ln = int(np.searchsorted(ls[:L], lo, "left"))
    rn = int(np.searchsorted(ls[1:], hi, "right")) - 1
    head_hi = min(hi, int(ls[min(ln, L)]))
    tail_lo = max(int(ls[min(max(rn + 1, ln), L)]), head_hi)
    windows = max(head_hi - lo, 0) + max(hi - tail_lo, 0)
    entries = windows
    i, covers = ln, 0
    while i <= rn and covers < max_cover:
        node, nxt = i, i + 1
        while pdl["is_first_child"][node] and pdl["parent_of"][node] >= 0:
            par = int(pdl["parent_of"][node])
            if pdl["next_leaf"][par] - 1 > rn:
                break
            node, nxt = L + par, int(pdl["next_leaf"][par])
        entries += int(pdl["doc_base"][node + 1] - pdl["doc_base"][node])
        i, covers = nxt, covers + 1
    return entries, i <= rn, windows


def pdl_host_arrays(pdl):
    from repro_torch.kernels.pdl_gather import iter_cap

    out = {f: getattr(pdl, f).cpu().numpy() for f in
           ("leaf_starts", "is_first_child", "parent_of", "next_leaf", "doc_base", "set_off",
            "A", "rule_left", "rule_right")}
    out.update(L=pdl.L, I=pdl.I, d=pdl.d, block_size=pdl.block_size, iter_cap=iter_cap(pdl))
    return out


def check_ranked_order(keys, docs, what):
    """(key desc, id asc) order of a row: keys non-increasing, ties by id."""
    for x in range(len(docs) - 1):
        require(keys[x] > keys[x + 1] or (keys[x] == keys[x + 1] and docs[x] < docs[x + 1]),
                (what, "row out of (desc, id asc) order"))


def check_topk(docs, tfs, lo, hi, codes, da, pdl, max_df, k):
    """Each row against the host oracle: exact where the engine's buffer
    holds the row; otherwise every document from DA[lo:hi] with a tf no
    larger than its true tf, in (tf desc, id asc) order.  Returns the number
    of exact rows."""
    from repro_torch.serve.planner import ENGINE_BRUTE

    exact_rows = 0
    for r in range(len(codes)):
        want_d, want_t, truth = host_topk(da, lo[r], hi[r], k)
        got = docs[r][docs[r] >= 0]
        nout = len(got)
        require(np.all(docs[r, nout:] == -1) and np.all(tfs[r, nout:] == 0), (r, "topk padding"))
        # Brute-L's window covers occ positions up to max_buf; the PDL gather
        # takes its cover's entries into max_buf slots unless the cover is cut
        if codes[r] == ENGINE_BRUTE:
            exact = hi[r] - lo[r] <= MAX_BUF and len(truth) <= max_df
        else:
            entries, cut = pdl_gather_entries(pdl, int(lo[r]), int(hi[r]))[:2]
            exact = entries <= MAX_BUF and not cut
        if exact:
            require(np.array_equal(got, want_d) and np.array_equal(tfs[r, :nout], want_t),
                    (r, "topk row != host (tf desc, id asc) oracle"))
            exact_rows += 1
        else:
            require(len(set(got.tolist())) == nout, (r, "duplicate documents"))
            for g, t in zip(got.tolist(), tfs[r, :nout].tolist()):
                require(g in truth and 1 <= t <= truth[g], (r, "tf above the true tf"))
            check_ranked_order(tfs[r, :nout], got, r)
    return exact_rows


def ulps(a, b):
    """ulp distance of non-negative float32 values."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def host_tfidf(da, d, ranges, conjunctive, k):
    """Host float32 oracle: weights lg(d / max(df, 1)) (correctly rounded
    from float64), scores folded term by term in slot order, a multiply
    then an add; (ranked top-k docs, every candidate's score, the
    candidates)."""
    lists = [host_topk(da, lo, hi, None)[2] for lo, hi in ranges]
    w = [np.float32(np.log2(np.float64(np.float32(d) / np.float32(max(len(t), 1)))))
         for t in lists]
    cands = set().union(*lists) if lists else set()
    if conjunctive:
        cands = {x for x in cands if all(x in t for t in lists)}
    score = {}
    for x in cands:
        s = np.float32(0.0)
        for t, wt in zip(lists, w):
            s = np.float32(s + np.float32(np.float32(t.get(x, 0)) * wt))
        score[x] = s
    ranked = sorted(cands, key=lambda x: (-score[x], x))[:k]
    return ranked, score, cands


def check_tfidf(docs, scores, term_ranges, da, d, pdl, conjunctive, k):
    """Each query against ``host_tfidf``: where no term's gather truncates,
    scores within 2 ulp and ids exact except among candidates whose oracle
    scores lie within 2 ulp; otherwise every document a true candidate with
    a score no higher than its true one, in (score desc, id asc) order.
    Returns (exact queries, the largest ulp distance seen)."""
    exact_q, worst = 0, 0
    for q, ranges in enumerate(term_ranges):
        ranked, score, cands = host_tfidf(da, d, ranges, conjunctive, k)
        got = docs[q][docs[q] >= 0]
        gs = scores[q, : len(got)]
        require(np.all(docs[q, len(got):] == -1), (q, "tfidf padding"))
        cover = [pdl_gather_entries(pdl, lo, hi)[:2] for lo, hi in ranges]
        if all(entries <= TFIDF_MAX_BUF and not cut for entries, cut in cover):
            require(len(got) == len(ranked), (q, "tfidf row length"))
            for g, s, want in zip(got.tolist(), gs, ranked):
                dist = int(ulps(s, score[want]))
                worst = max(worst, dist)
                require(dist <= 2, (q, "tfidf score beyond 2 ulp", s, score[want]))
                require(g == want or (g in score and ulps(score[g], score[want]) <= 2),
                        (q, "tfidf ranking differs outside a 2-ulp tie"))
            exact_q += 1
        else:
            require(len(set(got.tolist())) == len(got), (q, "duplicate documents"))
            for g, s in zip(got.tolist(), gs):
                require(g in cands and (s <= score[g] or ulps(s, score[g]) <= 2),
                        (q, "tfidf score above the true score"))
            check_ranked_order(gs, got, q)
    return exact_q, worst


def phase_topk_tfidf(dev, kernels):
    """Phase 2b: topk and tfidf on a service with both PDLs.  Returns the
    launches and, for phase 4, the service and its batches' ranges."""
    from repro_torch.data.collections import (
        generate, paperlike_collections, random_substring_patterns,
    )
    from repro_torch.serve.planner import ENGINE_CODES
    from repro_torch.serve.retrieval import RetrievalService

    coll = generate(paperlike_collections(scale=TOPK_SCALE)["dna-p001"])
    log(f"[topk] dna-p001 x{TOPK_SCALE}: n={coll.n} d={coll.d} sigma={coll.sigma}")
    t0 = time.perf_counter()
    svc = RetrievalService.build(coll, block_size=64, beta=16.0, device=dev)
    log(f"[topk] service build {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in svc.build_seconds.items())
        + f"; top-k PDL: {svc.pdl_topk.L} leaves, {svc.pdl_topk.I} internal nodes, "
        f"{svc.pdl_topk.total_docs_stored} stored entries, {svc.pdl_topk.nrules} rules")
    log(f"[topk] space report {svc.space_report()}")
    pats = random_substring_patterns(coll, 2000, 6, 128, device=dev)
    require(len(pats) >= 32, "workload generation produced too few patterns")
    batches = [pats[i:i + 32] for i in range(0, len(pats), 32)]
    bs = kernels[0]
    da = svc.da.cpu().numpy()
    d = svc.coll.d
    pdl = pdl_host_arrays(svc.pdl_topk)
    max_df = min(d + 1, MAX_BUF)
    rng = np.random.default_rng(0)
    # tf-idf queries as the serving CLI builds them: the pattern and a
    # second one drawn from the workload
    tf_queries = [[[p, pats[int(rng.integers(0, len(pats)))]] for p in batch]
                  for batch in batches]
    # ranges, outside the counted run
    plans = [svc.plan(b) for b in batches]
    term_plans = [svc.plan([t for qry in qs for t in qry]) for qs in tf_queries]

    lat, warm, mix, exact = {}, {}, [], {"topk": 0, "tfidf": 0}
    worst_ulp = 0
    topk_cases = (("auto", False), ("brute", False), ("pdl", False), ("ilcp", False),
                  ("auto", True))

    def topk_fns(batch, engine, pin):
        """(graph call, eager call) of one topk case."""
        fns = (lambda: svc.topk_arrays(batch, k=TOPK_K, engine=engine, max_buf=MAX_BUF),
               lambda: eager_endpoint(svc, "topk", batch, engine, k=TOPK_K, max_buf=MAX_BUF))
        return tuple(pinned(svc, f) for f in fns) if pin else fns

    def tfidf_fns(queries, conj):
        return (lambda: svc.tfidf_arrays(queries, k=TOPK_K, conjunctive=conj, max_terms=4,
                                         max_buf=TFIDF_MAX_BUF),
                lambda: eager_endpoint(svc, "tfidf", queries, k=TOPK_K, conjunctive=conj,
                                       max_buf=TFIDF_MAX_BUF))

    reset_counts(kernels)  # the topk/tfidf path's run starts here
    for bi, batch in enumerate(batches):
        plan = plans[bi]
        lo, hi = plan["lo"], plan["hi"]
        mix.append({name: int((plan["engine"] == code).sum())
                    for name, code in (("brute", 1), ("ilcp", 2), ("pdl", 3))})
        for engine, pin in topk_cases:
            name = f"topk[{engine}{',pinned' if pin else ''}]"
            docs, tfs = checked_call(svc, kernels, ("topk",) if pin else ("plan", "topk"),
                                     name, topk_fns(batch, engine, pin), lat, warm)
            require(docs.shape == tfs.shape == (len(batch), TOPK_K) and docs.dtype == np.int32)
            codes = plan["engine"] if engine == "auto" else [ENGINE_CODES[engine]] * len(batch)
            exact["topk"] += check_topk(docs, tfs, lo, hi, codes, da, pdl, max_df, TOPK_K)

        tlo, thi = term_plans[bi]["lo"], term_plans[bi]["hi"]
        ranges = [list(zip(tlo[2 * q:2 * q + 2].tolist(), thi[2 * q:2 * q + 2].tolist()))
                  for q in range(len(batch))]
        for conj in (False, True):
            name = f"tfidf[{'and' if conj else 'or'}]"
            docs, scores = checked_call(svc, kernels, ("tfidf",), name,
                                        tfidf_fns(tf_queries[bi], conj), lat, warm)
            require(docs.shape == scores.shape == (len(batch), TOPK_K)
                    and scores.dtype == np.float32 and np.isfinite(scores).all())
            eq, w = check_tfidf(docs, scores, ranges, da, d, pdl, conj, TOPK_K)
            exact["tfidf"] += eq
            worst_ulp = max(worst_ulp, w)
    launches = {"backward_search": bs.launches, "pdl_gather": kernels[4].launches}
    require(all(v > 0 for v in launches.values()), launches)
    require(all(n > 0 for n in warm.values()), ("an endpoint made no warm call", warm))
    log(f"[topk] {len(batches)} batches of 32, launches {launches}; warm calls (replays "
        f"only) {warm}; rows held exactly: "
        f"topk {exact['topk']} of {5 * len(pats)}, tfidf {exact['tfidf']} of "
        f"{2 * len(pats)} queries; largest tf-idf score distance {worst_ulp} ulp")
    log(f"[topk] engine mix per batch (auto): {mix}")
    log("[topk] host seconds per batch, first pass (a capture where the bucket or its "
        "window was new): "
        + "; ".join(f"{k} " + " ".join(f"{x:.4f}" for x in v) for k, v in lat.items()))
    log_programs(svc, "topk")
    calls = {}
    for bi, batch in enumerate(batches):
        for engine, pin in topk_cases:
            calls.setdefault(f"topk[{engine}{',pinned' if pin else ''}]", []).append(
                topk_fns(batch, engine, pin))
        for conj in (False, True):
            calls.setdefault(f"tfidf[{'and' if conj else 'or'}]", []).append(
                tfidf_fns(tf_queries[bi], conj))
    graph_against_eager(svc, kernels, calls, "topk")
    # where a batch's time goes: device busy time against the host clock
    profile_graph_and_eager("topk", "topk[pdl]", *topk_fns(batches[-1], "pdl", False), kernels)
    profile_graph_and_eager("topk", "tfidf[or]", *tfidf_fns(tf_queries[-1], False), kernels)
    term_ranges = [(torch.from_numpy(tp["lo"]).to(dev), torch.from_numpy(tp["hi"]).to(dev))
                   for tp in term_plans]
    plan_ranges = [(torch.from_numpy(pl["lo"]).to(dev), torch.from_numpy(pl["hi"]).to(dev))
                   for pl in plans]
    return launches, {"svc": svc, "ranges": plan_ranges, "term_ranges": term_ranges,
                      "batches": batches, "tf_queries": tf_queries}


# ---------------------------------------------------------------------------
# Phase 4b: the serving runtime, the reference engine, validation, the CLI
# ---------------------------------------------------------------------------

RUNTIME_QUERIES = 256   # requests per mode, as the serving CLI's default
RUNTIME_BATCH = 32
RUNTIME_DEADLINE_S = 0.5  # the serving CLI's default deadline
#: the endpoint programs one batch of each runtime mode runs
RUNTIME_KINDS = {"list": ("plan", "list"), "count": ("plan",), "topk": ("plan", "topk"),
                 "tfidf": ("tfidf",)}
RUNTIME_FAULTS = "executor_fail:0.2,executor_poison:0.2,slow_list,compile_error"
#: arguments the CLI runs take besides their mode (a CPU rehearsal adds
#: ``--device cpu``)
CLI_EXTRA_ARGS = ()


def runtime_batches(pats, mode, rng):
    """The CLI's traffic: batches of 32 drawn from the occ/df workload, a
    tf-idf query being the drawn pattern and a second one."""
    out = []
    for _ in range(RUNTIME_QUERIES // RUNTIME_BATCH):
        idx = rng.integers(0, len(pats), RUNTIME_BATCH)
        if mode == "tfidf":
            out.append([(mode, [pats[i], pats[int(rng.integers(0, len(pats)))]]) for i in idx])
        else:
            out.append([(mode, pats[i]) for i in idx])
    return out


def direct_answers(svc, cfg, mode, payloads, floor=False):
    """What the runtime's full (or floor) rung must answer for a batch: the
    service's endpoint called directly with the rung's own arguments."""
    k = cfg.floor_k if floor else cfg.k
    engine = "brute" if floor else "auto"
    if mode == "list":
        max_df = cfg.floor_max_df if floor else cfg.max_df
        docs, cnt = svc.list_docs_arrays(payloads, max_df=max_df, engine=engine,
                                         max_buf=cfg.max_buf)
        return [docs[i, :cnt[i]].tolist() for i in range(len(payloads))]
    if mode == "count":
        return [int(x) for x in svc.count(payloads)]
    if mode == "topk":
        docs, tfs = svc.topk_arrays(payloads, k=k, engine=engine, max_buf=cfg.max_buf)
        return [[(int(d), int(t)) for d, t in zip(docs[i], tfs[i]) if d >= 0]
                for i in range(len(payloads))]
    docs, scores = svc.tfidf_arrays(payloads, k=k, conjunctive=cfg.tfidf_conjunctive,
                                    max_buf=cfg.max_buf)
    return [[(int(d), float(x)) for d, x in zip(docs[i], scores[i]) if d >= 0]
            for i in range(len(payloads))]


def answer_ids(mode, result):
    """Every integer of an answer that must be a document id (or a count)."""
    if mode == "count":
        return [result]
    return [x[0] for x in result] if mode in ("topk", "tfidf") else list(result)


def serve_counted(rt, svc, kernels, mode, reqs, replay=REPLAY_LAUNCHES):
    """One serve call; each batch it ran must launch one replay of each
    program of the mode (no capture, no other kernel).  Returns (answers,
    s)."""
    before = [k.launches for k in kernels]
    tally, nb = dict(svc.compile_counts), rt.metrics.batches
    t = time.perf_counter()
    answers = rt.serve(reqs)
    dt = time.perf_counter() - t
    nb = rt.metrics.batches - nb
    want = tuple(nb * sum(replay[kind].get(k.__name__, 0)
                          for kind in RUNTIME_KINDS[mode]) for k in kernels)
    delta = tuple(k.launches - b for k, b in zip(kernels, before))
    require(delta == want, ("runtime", mode, "launches", delta, "want", want))
    require(svc.compile_counts == tally, ("runtime", mode, "captured in the steady run"))
    return answers, dt


def runtime_traffic(services, batches, kernels):
    """Clean traffic through ``ServeRuntime`` in every mode, then the same
    requests under injected faults, then each degradation rung forced once
    per mode.  Returns the clean run's launches."""
    from repro_torch.serve import faults
    from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime

    clean, launches = {}, {}
    reset_counts(kernels)  # the runtime path's run starts here (warm passes included)
    for mode, svc in services.items():
        cfg = RuntimeConfig(max_batch=RUNTIME_BATCH, k=TOPK_K,
                            max_df=min(256, svc.coll.d + 1),
                            default_deadline_s=RUNTIME_DEADLINE_S)
        rt = ServeRuntime(svc, cfg)
        for _ in range(2):  # the CLI's two warm passes, over every batch of the run
            for reqs in batches[mode]:
                rt.serve(reqs, deadline_s=1e9)
        lat, direct_s, clean[mode] = [], [], []
        for reqs in batches[mode]:
            answers, dt = serve_counted(rt, svc, kernels, mode, reqs)
            lat.append(dt)
            with uncounted(kernels):
                t = time.perf_counter()
                want = direct_answers(svc, cfg, mode, [p for _, p in reqs])
                direct_s.append(time.perf_counter() - t)
            require(all(a.path == "full" and not a.degraded and a.retries == 0
                        and not a.deadline_missed for a in answers), ("runtime", mode))
            require([a.result for a in answers] == want,
                    ("runtime", mode, "answer differs from the direct endpoint call"))
            clean[mode].append(want)
        m = rt.metrics
        require(m.answered == 3 * RUNTIME_QUERIES and m.degraded == 0 and m.retries == 0
                and m.failures == 0 and m.short_circuits == 0 and m.deadline_misses == 0,
                ("runtime", mode, m.as_dict()))
        ms, dms = np.asarray(lat) * 1e3, np.asarray(direct_s) * 1e3
        log(f"[runtime] {mode} clean: {RUNTIME_QUERIES} queries, batch {RUNTIME_BATCH}: "
            f"steady p50 {np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} ms "
            f"({RUNTIME_QUERIES / ms.sum() * 1e3:.0f} q/s); direct endpoint call p50 "
            f"{np.percentile(dms, 50):.3f} ms p99 {np.percentile(dms, 99):.3f} ms; runtime "
            f"overhead at p50 {np.percentile(ms, 50) - np.percentile(dms, 50):.3f} ms; "
            f"metrics {m.as_dict()}")
    launches = {k.__name__: k.launches for k in kernels}
    require(launches["backward_search"] > 0 and launches["pdl_gather"] > 0, launches)

    # injected faults over the same requests: every request answered, no
    # POISON, reasons "cause:path", every rung's answers what it must be
    specs = faults.parse_fault_specs(RUNTIME_FAULTS)
    with uncounted(kernels):
        for mode, svc in services.items():
            cfg = RuntimeConfig(max_batch=RUNTIME_BATCH, k=TOPK_K,
                                max_df=min(256, svc.coll.d + 1),
                            default_deadline_s=RUNTIME_DEADLINE_S)
            rt = ServeRuntime(svc, cfg)
            served, paths = [], {}
            t = time.perf_counter()
            with faults.inject(*specs) as inj:
                for reqs in batches[mode]:
                    served.append(rt.serve(reqs))
            seconds = time.perf_counter() - t
            for bi, (reqs, answers) in enumerate(zip(batches[mode], served)):
                check_rungs(svc, cfg, mode, reqs, answers, clean[mode][bi])
                for a in answers:
                    paths[a.path] = paths.get(a.path, 0) + 1
            m = rt.metrics
            require(m.answered == RUNTIME_QUERIES, (mode, m.as_dict()))
            log(f"[runtime] {mode} injected ({RUNTIME_FAULTS}): {seconds:.2f} s, answers by "
                f"path {paths}, {len(inj.fired)} faults fired, retries {m.retries}, "
                f"breaker trips {m.breaker_trips}, deadline misses {m.deadline_misses}, "
                f"reasons {dict(m.degrade_reasons)}")
            # each rung forced once: the full path fails every attempt, then
            # the floor runs (limit) or fails too (no limit)
            site = "plan" if mode == "count" else f"executor:{mode}"
            forced = {}
            for rung, limit in (("floor", cfg.max_retries + 1), ("reference", None)):
                rt = ServeRuntime(svc, cfg)
                with faults.inject(faults.FaultSpec(site, "error", rate=1.0, limit=limit)):
                    answers = rt.serve(batches[mode][0])
                require({a.path for a in answers} == {rung}, (mode, rung, answers[0]))
                check_rungs(svc, cfg, mode, batches[mode][0], answers, clean[mode][0])
                forced[rung] = rt.metrics.retries
            log(f"[runtime] {mode} forced rungs: floor and reference each answered a batch "
                f"as they must (retries {forced})")
    return launches


def check_rungs(svc, cfg, mode, reqs, answers, full):
    """A serve call's answers (the runtime may cut the call into smaller
    batches): complete, POISON-free, each degraded one flagged
    ``cause:path``; the full and reference rungs' answers equal to the full
    path's, the floor's to the endpoint called with the floor's arguments."""
    from repro_torch.serve.faults import POISON

    require(len(answers) == len(reqs) and all(a.path != "empty" for a in answers),
            (mode, [a.path for a in answers]))
    floor = None
    for i, a in enumerate(answers):
        require(int(POISON) not in answer_ids(mode, a.result), (mode, "POISON answered"))
        if a.degraded:
            cause, _, path = (a.degrade_reason or "").partition(":")
            require(path == a.path and cause in ("retries_exhausted", "breaker_open"),
                    (mode, a.degrade_reason, a.path))
        if a.path == "floor":
            if floor is None:
                floor = direct_answers(svc, cfg, mode, [p for _, p in reqs], floor=True)
            require(a.result == floor[i], (mode, "floor answer differs from the floor's call"))
        else:
            require(a.result == full[i], (mode, a.path, "answer differs from the full path's"))


def reference_engine(full_svc, topk_svc, full_batch, tf_batch, kernels):
    """``engine="reference"`` on the card against the graph programs on a
    batch of 32, with its launches: 1 backward search per ``_ranges_dfs``,
    1 ILCP listing per ILCP query, 1 PDL gather per PDL query (tf-idf: one
    gather for the batch).  Returns the launches."""
    from repro_torch.serve.planner import ENGINE_BRUTE, ENGINE_EMPTY, ENGINE_PDL

    max_df = min(MAX_DF, full_svc.coll.d + 1)
    names = [k.__name__ for k in kernels]
    times = {}

    def run(label, fn, graph_fn, want):
        before = [k.launches for k in kernels]
        t = time.perf_counter()
        got = fn()
        times[label] = time.perf_counter() - t
        delta = {n: k.launches - b for n, k, b in zip(names, kernels, before)}
        require({n: v for n, v in delta.items() if v} == {n: v for n, v in want.items() if v},
                (label, "launches", delta, "want", want))
        with uncounted(kernels):
            require(got == graph_fn(), (label, "differs from the graph program"))

    def engine_counts(plan):
        """(queries with a non-empty range, those the auto plan sends to PDL)."""
        return (int((plan["engine"] != ENGINE_EMPTY).sum()),
                int((plan["engine"] == ENGINE_PDL).sum()))

    tbatch = [p for p, _ in tf_batch]
    with uncounted(kernels):
        plan = full_svc.plan(full_batch)
        nonempty, auto_pdl = engine_counts(plan)
        t_nonempty, t_auto_pdl = engine_counts(topk_svc.plan(tbatch))
    mix = {name: int((plan["engine"] == code).sum())
           for name, code in (("brute", ENGINE_BRUTE), ("pdl", ENGINE_PDL))}
    reset_counts(kernels)  # the reference engine's run starts here
    svc = full_svc
    for sub in ("auto", "brute", "ilcp", "pdl"):
        eng = "reference" if sub == "auto" else f"reference:{sub}"
        want = {"backward_search": 1, "ilcp_list": nonempty if sub == "ilcp" else 0,
                "pdl_gather": {"auto": auto_pdl, "pdl": nonempty}.get(sub, 0)}
        run(f"list_docs[{eng}]",
            lambda e=eng: svc.list_docs(full_batch, max_df=max_df, engine=e, max_buf=MAX_BUF),
            lambda s=sub: svc.list_docs(full_batch, max_df=max_df, engine=s, max_buf=MAX_BUF),
            want)
    run("count[reference]", lambda: svc.count(full_batch, engine="reference").tolist(),
        lambda: svc.count(full_batch).tolist(), {"backward_search": 1})
    for eng, n_pdl in (("reference", t_auto_pdl), ("reference:pdl", t_nonempty)):
        run(f"topk[{eng}]",
            lambda e=eng: topk_svc.topk(tbatch, k=TOPK_K, engine=e, max_buf=MAX_BUF),
            lambda e=eng: topk_svc.topk(tbatch, k=TOPK_K, engine=e.partition(":")[2] or "auto",
                                        max_buf=MAX_BUF),
            {"backward_search": 1, "pdl_gather": n_pdl})
    queries = [list(q) for q in tf_batch]
    for conj in (False, True):
        run(f"tfidf[reference,{'and' if conj else 'or'}]",
            lambda c=conj: topk_svc.tfidf(queries, k=TOPK_K, conjunctive=c,
                                          max_buf=TFIDF_MAX_BUF, engine="reference"),
            lambda c=conj: topk_svc.tfidf(queries, k=TOPK_K, conjunctive=c,
                                          max_buf=TFIDF_MAX_BUF),
            {"backward_search": len(queries), "pdl_gather": 1})
    launches = {k.__name__: k.launches for k in kernels}
    log(f"[reference] engine='reference' on a batch of 32 (auto mix {mix}), bit-identical to "
        f"the graph programs; seconds per batch: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + f"; launches {launches}")
    return launches


def validation_checks(full_svc, topk_svc):
    """Both builds validated (build(validate=True)); a flipped wavelet word
    and a flipped DA entry must raise ``IndexIntegrityError``."""
    import dataclasses

    from repro_torch.errors import IndexIntegrityError
    from repro_torch.serve.validate import validate_csa, verify_fingerprints

    for label, svc in (("full", full_svc), ("topk", topk_svc)):
        require(sorted(svc.fingerprints) == sorted(
            ["csa", "ilcp", "pdl_list", "sada", "da"]
            + (["pdl_topk"] if svc.pdl_topk is not None else [])), svc.fingerprints)
        log(f"[validate] {label} (n = {svc.coll.n}): build(validate=True) "
            f"{svc.build_seconds['validate']:.3f} s; fingerprints {svc.fingerprints}")
    csa = full_svc.csa
    words = csa.wm.words.clone()
    words[0, 0] ^= 1
    bad = dataclasses.replace(csa, wm=dataclasses.replace(csa.wm, words=words))
    try:
        validate_csa(bad)
        require(False, "a flipped wavelet-matrix word passed validation")
    except IndexIntegrityError as e:
        log(f"[validate] flipped wavelet word: IndexIntegrityError({e})")
    da = full_svc.da.clone()
    da[0] = (da[0] + 1) % full_svc.coll.d
    try:
        verify_fingerprints(dataclasses.replace(full_svc, da=da), full_svc.fingerprints)
        require(False, "a flipped DA entry passed the fingerprint check")
    except IndexIntegrityError as e:
        log(f"[validate] flipped DA entry: IndexIntegrityError({e})")


def cli_runs():
    """``python -m repro_torch.launch.serve`` twice: clean ``--mode topk``
    (no degradation, no retry) and ``--mode list`` under injected faults
    (exit 0, every query served)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = (("topk", ["--mode", "topk"]),
            ("list", ["--mode", "list", "--inject", "executor_fail:0.2,slow_list"]))
    for label, args in runs:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args, *CLI_EXTRA_ARGS]
        t = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        seconds = time.perf_counter() - t
        lines = out.stdout.splitlines()
        require(out.returncode == 0, (cmd, out.returncode, out.stderr[-2000:]))
        steady = next(x for x in lines if "steady p50" in x)
        resil = next(x for x in lines if x.startswith("resilience:"))
        queries = int(steady.split(": ", 1)[1].split(" queries")[0])
        require(queries >= RUNTIME_QUERIES and steady.startswith(f"{label}: "), steady)
        if "--inject" not in args:
            require("degraded_fraction=0.000" in resil and "retries=0 " in resil, resil)
        log(f"[cli] {' '.join(args)}: {seconds:.1f} s; {lines[0]}")
        log(f"[cli]   {steady}")
        log(f"[cli]   {resil}")


def phase_runtime(full_svc, full_batches, topk, kernels):
    """Phase 4b on the services of phases 2 and 2b (no new build)."""
    rng = np.random.default_rng(0)
    full_pats = [p for b in full_batches for p in b]
    topk_pats = [p for b in topk["batches"] for p in b]
    services = {"list": full_svc, "count": full_svc, "topk": topk["svc"],
                "tfidf": topk["svc"]}
    batches = {mode: runtime_batches(full_pats if mode in ("list", "count") else topk_pats,
                                     mode, rng) for mode in services}
    t0 = time.perf_counter()
    runtime = runtime_traffic(services, batches, kernels)
    log(f"[runtime] traffic {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref = reference_engine(full_svc, topk["svc"], full_batches[0],
                           [p for _, p in batches["tfidf"][0]], kernels)
    log(f"[reference] {time.perf_counter() - t0:.1f} s")
    validation_checks(full_svc, topk["svc"])
    t0 = time.perf_counter()
    cli_runs()
    log(f"[cli] {time.perf_counter() - t0:.1f} s")
    return runtime, ref


def phase_primitives(large, kernels):
    """Phase 3b: wm_rank_batch and the kernel-routed ilcp_list_docs_da_batch
    on the large index."""
    from repro_torch.core.ilcp import ilcp_list_docs_da_batch
    from repro_torch.kernels.ilcp_list import lockstep_iteration_cap
    from repro_torch.succinct.wavelet import wm_rank_batch

    rk, rq = kernels
    csa, ilcp = large["csa"], large["ilcp"]
    wm, n, dev = csa.wm, csa.n, large["da"].device
    bwt = large["bwt"]
    pats = large["pats"]
    plan_lo = torch.cat([lo for lo, _ in large["ranges"]]).cpu().numpy()
    edge_i = [0, 1, 31, 32, 33, n - 1, n]
    c = np.asarray([int(p[0]) for p in pats] + [0] * len(edge_i)
                   + [csa.sigma - 1] * len(edge_i), np.int32)
    i = np.asarray(plan_lo.tolist() + edge_i + edge_i, np.int32)
    # host oracle: occurrences of c in BWT[0:i]
    positions = {s: np.flatnonzero(bwt == s) for s in np.unique(c).tolist()}
    want = np.asarray([np.searchsorted(positions[s], p) for s, p in zip(c.tolist(), i.tolist())])
    vilcp, table = ilcp.vilcp.cpu().numpy(), ilcp.rmq.table.cpu().numpy()
    run_starts, da = ilcp.run_starts.cpu().numpy(), large["da"].cpu().numpy()
    iters = []
    for lo, hi in large["ranges"]:
        it = host_ilcp_list(vilcp, table, run_starts, da, lo.cpu().numpy(), hi.cpu().numpy(),
                            ilcp.d, MAX_DF)[4]
        iters.append(min(max(it), lockstep_iteration_cap(MAX_DF)))

    reset_counts(kernels)  # the primitives' run starts here
    t = time.perf_counter()
    got = wm_rank_batch(wm, torch.from_numpy(c).to(dev), torch.from_numpy(i).to(dev))
    torch.cuda.synchronize()
    rank_s = time.perf_counter() - t
    require(rk.launches == wm.levels, ("wm_rank_batch launches", rk.launches, wm.levels))
    require(np.array_equal(got.cpu().numpy(), want), "wm_rank_batch != host count over the BWT")
    lat = []
    for b, (lo, hi) in enumerate(large["ranges"]):
        before = rq.launches
        t = time.perf_counter()
        docs, cnt = ilcp_list_docs_da_batch(ilcp, large["da"], lo, hi, MAX_DF)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        fused_docs, fused_cnt = large["listed"][b]
        require(torch.equal(docs, fused_docs) and torch.equal(cnt, fused_cnt),
                (b, "ilcp_list_docs_da_batch != the fused listing kernel"))
        require(rq.launches - before == iters[b],
                (b, "rmq launches", rq.launches - before, "lockstep iterations", iters[b]))
    launches = {"rank": rk.launches, "rmq": rq.launches}
    require(launches["rank"] > 0 and launches["rmq"] > 0, launches)
    log(f"[prims] wm_rank_batch of {len(i)} (symbol, position) pairs: {rank_s:.4f} s, "
        f"{rk.launches} rank launches ({wm.levels} levels)")
    log(f"[prims] ilcp_list_docs_da_batch, {len(lat)} batches of 128: lockstep iterations "
        f"{iters}, host seconds " + " ".join(f"{x:.3f}" for x in lat))
    return launches, (c, i)


def phase_large(dev, bs, il):
    from repro_torch.core.csa import build_csa
    from repro_torch.core.ilcp import build_ilcp, ilcp_list_docs_da_planned
    from repro_torch.core.sada import build_sada
    from repro_torch.core.suffix import build_suffix_data
    from repro_torch.data.collections import (
        generate, paperlike_collections, random_substring_patterns, pad_patterns,
    )
    from repro_torch.serve.planner import plan_knobs, plan_queries

    coll = generate(paperlike_collections(scale=LARGE_SCALE)["dna-p001"])
    log(f"[large] dna-p001 x{LARGE_SCALE}: n={coll.n} d={coll.d}")
    stages = {}
    t = time.perf_counter()
    data = build_suffix_data(coll, dev)
    torch.cuda.synchronize()
    stages["suffix"] = time.perf_counter() - t
    t = time.perf_counter()
    csa = build_csa(data)
    torch.cuda.synchronize()
    stages["csa"] = time.perf_counter() - t
    t = time.perf_counter()
    sada = build_sada(data)
    torch.cuda.synchronize()
    stages["sada"] = time.perf_counter() - t
    t = time.perf_counter()
    ilcp = build_ilcp(data)
    torch.cuda.synchronize()
    stages["ilcp"] = time.perf_counter() - t
    log("[large] build " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    pats = random_substring_patterns(coll, 4000, 6, LARGE_QUERIES, data=data)
    require(len(pats) == LARGE_QUERIES, len(pats))
    da = data.da.cpu().numpy()
    batches = []
    for i in range(0, len(pats), 128):
        p, ln = pad_patterns(pats[i:i + 128], 8)
        batches.append((torch.from_numpy(p).to(dev), torch.from_numpy(ln).to(dev)))
    knobs = plan_knobs(4.0, "auto", dev)
    reset_counts((bs, il))
    t = time.perf_counter()
    results = []
    for p, ln in batches:
        plan = plan_queries(csa, sada, p, ln, *knobs)
        docs, cnt = ilcp_list_docs_da_planned(ilcp, data.da, plan.lo, plan.hi, MAX_DF)
        results.append((plan, docs, cnt))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = {"backward_search": bs.launches, "ilcp_list": il.launches}
    require(launches == {"backward_search": len(batches), "ilcp_list": len(batches)}, launches)
    for plan, docs, cnt in results:
        lo, hi = plan.lo.cpu().numpy(), plan.hi.cpu().numpy()
        df = plan.df.cpu().numpy()
        truth = np.asarray([len(set(da[a:b].tolist())) for a, b in zip(lo, hi)])
        require(np.array_equal(df, truth), "large: df != distinct docs of DA[lo:hi]")
        docs, cnt = docs.cpu().numpy(), cnt.cpu().numpy()
        check_listing(docs, cnt, lo, hi, da, MAX_DF, sorted_rows=False)
        require(np.all(cnt == np.minimum(truth, MAX_DF)), "large: truncated count")
    log(f"[large] {len(pats)} patterns in {len(batches)} batches: {run_s:.3f} s, "
        f"launches {launches}")
    sa = data.sa.cpu().numpy().astype(np.int64)
    large = {"csa": csa, "ilcp": ilcp, "da": data.da, "data": data, "batches": batches,
             "ranges": [(plan.lo, plan.hi) for plan, _, _ in results],
             "listed": [(docs, cnt) for _, docs, cnt in results], "pats": pats,
             "bwt": np.asarray(coll.text, np.int32)[(sa - 1) % coll.n]}
    log(f"[large] ILCP runs rho={ilcp.nruns}")
    return large


def kernel_checks(svc, full_batches, large, lat):
    """Phase 4: each kernel against its plain version, bit for bit.
    ``lat``: the dependent-load latencies of ``load_latency_ns``."""
    from repro_torch.core.csa import search_base
    from repro_torch.kernels.backward_search import (
        backward_search, backward_search_plain, reverse_patterns,
    )
    from repro_torch.kernels.ilcp_list import ilcp_list, ilcp_list_plain, runs_of

    def bws_case(csa, pats, lens):
        wm = csa.wm
        args = (wm.words, wm.ones_prefix, wm.zcount, search_base(csa))
        kw = dict(n=csa.n, sigma=csa.sigma)
        k = backward_search(*args, pats, lens, **kw)
        p = backward_search_plain(*args, reverse_patterns(pats, lens), lens, **kw)
        return k, p, (lambda: backward_search(*args, pats, lens, **kw)), \
            (lambda: backward_search_plain(*args, reverse_patterns(pats, lens), lens, **kw))

    def il_case(index, da, lo, hi, max_df):
        a = (index.vilcp, index.rmq.table, index.run_starts, da)
        kw = dict(d=index.d, max_df=max_df)
        k = ilcp_list(*a, lo, hi, **kw)
        lr, hr = runs_of(index.run_starts, lo), runs_of(index.run_starts, hi - 1)
        p = ilcp_list_plain(*a, lo, hi, lr, hr, **kw)
        return k, p, (lambda: ilcp_list(*a, lo, hi, **kw)), \
            (lambda: ilcp_list_plain(*a, lo, hi, lr, hr, **kw))

    def mismatches(k, p):
        return sum(int((x != y).sum()) for x, y in zip(k, p))

    def max_err(k, p):
        return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                   for x, y in zip(k, p))

    dev = svc.da.device
    gen = torch.Generator().manual_seed(0)
    total = {"backward_search": 0, "ilcp_list": 0}
    errs = {"backward_search": 0, "ilcp_list": 0}

    def tally(name, k, p, label):
        mm = mismatches(k, p)
        total[name] += mm
        errs[name] = max(errs[name], max_err(k, p))
        log(f"[kernels] {name} {label}: mismatches {mm}")

    # -- backward search: main-path batches of both phases and edge rows
    from repro_torch.data.collections import pad_patterns
    main_pats = []
    for batch in full_batches:
        p, ln = pad_patterns(batch, 8)
        main_pats.append((torch.from_numpy(p).to(dev), torch.from_numpy(ln).to(dev)))
    for i, (p, ln) in enumerate(main_pats):
        k, pl, _, _ = bws_case(svc.csa, p, ln)
        tally("backward_search", k, pl, f"full batch {i}")
    for i, (p, ln) in enumerate(large["batches"]):
        k, pl, _, _ = bws_case(large["csa"], p, ln)
        tally("backward_search", k, pl, f"large batch {i}")
    sigma = svc.csa.sigma
    edge = torch.randint(0, sigma, (33, 9), generator=gen, dtype=torch.int32)
    edge_len = torch.randint(0, 10, (33,), generator=gen, dtype=torch.int32)
    edge[::4, 2] = -1
    edge[1::4, 0] = sigma
    edge_len[::5] = 0
    k, pl, _, _ = bws_case(svc.csa, edge.to(dev), edge_len.to(dev))
    tally("backward_search", k, pl, "edge rows (B=33, len 0, symbols -1 and sigma)")

    # -- ILCP listing: ranges of the main path, truncation, empty/padded rows
    full_ranges = []
    for p, ln in main_pats:
        lo, hi = backward_search(svc.csa.wm.words, svc.csa.wm.ones_prefix, svc.csa.wm.zcount,
                                 search_base(svc.csa), p, ln, n=svc.csa.n, sigma=sigma)
        full_ranges.append((lo, torch.where(ln > 0, hi, lo)))
    n = svc.csa.n
    for i, (lo, hi) in enumerate(full_ranges):
        k, pl, _, _ = il_case(svc.ilcp, svc.da, lo, hi, MAX_DF)
        tally("ilcp_list", k, pl, f"full batch {i}")
    lo0, hi0 = full_ranges[0]
    elo = torch.cat([lo0[:29], torch.tensor([0, 5, 7, 0], dtype=torch.int32, device=dev)])
    ehi = torch.cat([hi0[:29], torch.tensor([0, 5, 3, n], dtype=torch.int32, device=dev)])
    for max_df in (1, 2, 8):
        k, pl, _, _ = il_case(svc.ilcp, svc.da, elo, ehi, max_df)
        tally("ilcp_list", k, pl, f"edge ranges (B=33, max_df={max_df})")
    for i, (plan_lo, plan_hi) in enumerate(large["ranges"]):
        k, pl, _, _ = il_case(large["ilcp"], large["da"], plan_lo, plan_hi, MAX_DF)
        tally("ilcp_list", k, pl, f"large batch {i}")
        if i == 1:
            break  # two large batches are enough for the plain version's pace
    require(total == {"backward_search": 0, "ilcp_list": 0}, total)

    # -- times at the main-path shapes, bounds from this run's work
    records = []
    words = svc.csa.wm.words.cpu().numpy()
    prefix = svc.csa.wm.ones_prefix.cpu().numpy()
    zcount = svc.csa.wm.zcount.cpu().numpy()
    base = search_base(svc.csa).cpu().numpy()
    p, ln = main_pats[0]
    _, _, fk, fp = bws_case(svc.csa, p, ln)
    kms, pms = cuda_time_ms(fk, 50), cuda_time_ms(fp, 10)
    kdev, kprof = queued_time_ms(fk, 50), device_ms_of(profile_calls(fk, 20),
                                                       "backward_search_kernel")
    hlo, hhi, steps, bw_chains = host_backward_search(words, prefix, zcount, base,
                                                      p.cpu().numpy(), ln.cpu().numpy(), n, sigma)
    klo, khi = fk()
    require(np.array_equal(hlo, klo.cpu().numpy()) and np.array_equal(hhi, khi.cpu().numpy()))
    levels = words.shape[0]
    B, max_m = p.shape
    bw_lat_ms, bw_rounds = longest(bw_chains, lat)
    steps = sum(steps)
    bw_bytes = steps * levels * 2 * 8 + steps * 4 + B * max_m * 4 + B * 4 + 2 * B * 4
    bw_ops = steps * levels * 2 * 10
    records.append(dict(
        name="backward_search", route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
        replaces="src/repro/kernels/backward_search.py:92",
        launches=None, max_abs_err=errs["backward_search"], mismatches=total["backward_search"],
        ms=kms, kernel_ms=kms, device_ms=kdev, profiler_device_ms=kprof, plain_ms=pms,
        library_ms=None,
        bound_ms=max(bw_bytes / HBM_BYTES_PER_S, bw_ops / ALU_OPS_PER_S) * 1e3,
        bound_by="bytes" if bw_bytes / HBM_BYTES_PER_S >= bw_ops / ALU_OPS_PER_S else "operations",
        latency_chain=bw_rounds, latency_bound_ms=bw_lat_ms,
        shape=f"B={B} max_m={max_m} levels={levels} n={n} active_steps={steps}",
    ))

    lo, hi = full_ranges[0]
    # the main path hands the kernel the ILCP-assigned ranges; with engine="ilcp"
    # that is every row
    _, _, fk, fp = il_case(svc.ilcp, svc.da, lo, hi, MAX_DF)
    kms, pms = cuda_time_ms(fk, 20), cuda_time_ms(fp, 2)
    kdev, kprof = queued_time_ms(fk, 20), device_ms_of(profile_calls(fk, 20), "ilcp_list_kernel")
    idx = svc.ilcp
    hd, hc, pops, scanned, _, chains = host_ilcp_list(
        idx.vilcp.cpu().numpy(), idx.rmq.table.cpu().numpy(), idx.run_starts.cpu().numpy(),
        svc.da.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy(), idx.d, MAX_DF)
    kd, kc = fk()
    require(np.array_equal(hd, kd.cpu().numpy()) and np.array_equal(hc, kc.cpu().numpy()),
            "ilcp_list kernel != host replay of the recursion")
    B = lo.shape[0]
    il_bytes = pops * 24 + scanned * 4 + B * 16 + B * (MAX_DF + 1) * 4
    il_ops = pops * 30 + scanned * 8
    records.append(dict(
        name="ilcp_list", route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
        replaces="src/repro/kernels/ilcp_list.py:193",
        launches=None, max_abs_err=errs["ilcp_list"], mismatches=total["ilcp_list"],
        ms=kms, kernel_ms=kms, device_ms=kdev, profiler_device_ms=kprof, plain_ms=pms,
        library_ms=None,
        bound_ms=max(il_bytes / HBM_BYTES_PER_S, il_ops / ALU_OPS_PER_S) * 1e3,
        bound_by="bytes" if il_bytes / HBM_BYTES_PER_S >= il_ops / ALU_OPS_PER_S else "operations",
        latency_chain=longest(chains, lat)[1], latency_bound_ms=longest(chains, lat)[0],
        shape=f"B={B} max_df={MAX_DF} d={idx.d} rho={idx.nruns} pops={pops} scanned={scanned}",
    ))

    # the large index: one batch of 128 for each kernel
    p, ln = large["batches"][0]
    _, _, fk, fp = bws_case(large["csa"], p, ln)
    records[0]["large_ms"] = cuda_time_ms(fk, 50)
    records[0]["large_device_ms"] = queued_time_ms(fk, 50)
    records[0]["large_plain_ms"] = cuda_time_ms(fp, 10)
    lo, hi = large["ranges"][0]
    _, _, fk, fp = il_case(large["ilcp"], large["da"], lo, hi, MAX_DF)
    records[1]["large_ms"] = cuda_time_ms(fk, 20)
    records[1]["large_device_ms"] = queued_time_ms(fk, 20)
    records[1]["large_plain_ms"] = cuda_time_ms(fp, 2)
    return records


def load_latency_ns(dev, footprints=(16 << 10, 16 << 20, 256 << 20), steps=200_000):
    """Nanoseconds of one dependent 4-byte global load: one thread chasing
    a random cycle over each footprint in bytes (the probe kernel, through
    the read-only path), each cycle read once first: 16 KB sits in the L1,
    16 MB in the L2, 256 MB in neither.  ``l1_ns``, ``l2_ns``, ``dram_ns``."""
    from repro_torch.kernels import _build

    lib = _build.library()
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(7)
    result = {}
    for nbytes in footprints:
        n = nbytes // 4
        perm = torch.randperm(n, device=dev, generator=gen)
        nxt = torch.empty(n, dtype=torch.int32, device=dev)
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        del perm
        int(nxt.sum())  # one pass over the cycle: the L2 holds what fits
        _build.check(lib.rt_chase(nxt.data_ptr(), 1000, out.data_ptr(), stream), "chase")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        _build.check(lib.rt_chase(nxt.data_ptr(), steps, out.data_ptr(), stream), "chase")
        stop.record()
        torch.cuda.synchronize()
        result[nbytes] = start.elapsed_time(stop) * 1e6 / steps
        del nxt
    log("[latency] dependent load: " + ", ".join(f"{b >> 10} KB cycle {ns:.1f} ns"
                                                 for b, ns in result.items()))
    return {"l1_ns": result[footprints[0]], "l2_ns": result[footprints[1]],
            "dram_ns": result[footprints[2]]}


def launch_floor_ms(dev, reps=200) -> float:
    """Device milliseconds per launch of the probe's empty kernel, queued
    behind the spin like the index kernels' device times: the floor under
    a small kernel's device time."""
    from repro_torch.kernels import _build

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = queued_time_ms(lambda: _build.check(lib.rt_empty(stream), "empty"), reps)
    log(f"[latency] empty kernel: {ms * 1e3:.3f} us a launch, queued")
    return ms


def no_sync_checks(full_svc, full_ranges, topk_svc, topk_ranges, max_df):
    """The three executor calls under ``set_sync_debug_mode("error")``: any
    host sync inside them raises."""
    from repro_torch.core.ilcp import ilcp_list_docs_da_planned
    from repro_torch.core.pdl import pdl_doc_freqs_batch, pdl_list_docs_batch

    lo, hi = full_ranges
    tlo, thi = topk_ranges
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pdl_list_docs_batch(full_svc.pdl_list, full_svc.csa, lo, hi, max_df, MAX_BUF)
        pdl_doc_freqs_batch(topk_svc.pdl_topk, topk_svc.csa, tlo, thi, MAX_BUF)
        ilcp_list_docs_da_planned(full_svc.ilcp, full_svc.da, lo, hi, max_df)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[nosync] pdl_list_docs_batch, pdl_doc_freqs_batch, ilcp_list_docs_da_planned: "
        "no host sync")


def pdl_walk_ns(hp, csa, doc_starts, lo, hi, max_buf, max_cover, lat, lanes, rounds_held):
    """Latency bound of one query of the gather kernel (listing mode), in
    ns, its rounds and its cover's shape, on the block's critical path:
    the leaf searches; the windows' LF walks spread over the ``lanes``
    threads (per thread its positions, each step a sampled-position search
    and a wavelet descent, every read taken as an L1 hit); then per chunk of
    ``lanes`` leaves the longest climb of a leaf (per step the node's parent
    and first-child flag, then its next leaf), the chain's serial links
    where a climb ends past the leaf after it (one shared-memory read each,
    at an L1 hit's latency) and one round of the members' list sizes; and
    per expansion phase (the members of up to ``rounds_held`` chunks, as
    the kernel holds them) the longest member's expansion (its list bounds,
    then per step the list symbol or a rule's two children).  Each thread's
    reads are a ``Chain`` that counts as L1 hits the lines the block read
    in an earlier phase.  The scan's shuffles, the barriers, the shared
    counter that deals the members, the shared-memory stack and a thread's
    other members are not counted."""
    from repro_torch.core.csa import csa_lookup

    L, top = hp["L"], hp["L"] + hp["I"] - 1
    ls, db, so = hp["leaf_starts"], hp["doc_base"], hp["set_off"]
    A, d, rl, rr = hp["A"], hp["d"], hp["rule_left"], hp["rule_right"]
    ch = Chain()
    ln = ch.search("leaf_starts", ls[:L], lo)
    rn = ch.search("leaf_starts", ls[1:], hi, right=True) - 1
    ch.read(("leaf_starts", min(ln, L) >> 5))
    ch.read(("leaf_starts", min(max(rn + 1, ln), L) >> 5))
    head_hi = min(hi, int(ls[min(ln, L)]))
    tail_lo = max(int(ls[min(max(rn + 1, ln), L)]), head_hi)
    wh, wt = min(max(head_hi - lo, 0), hp["block_size"]), min(max(hi - tail_lo, 0),
                                                               hp["block_size"])
    seen = set(ch.lines)
    rounds = {"l2_rounds": ch.l2, "l1_rounds": ch.l1}
    head_ns = ch.ns(lat)
    windows_ns = 0.0
    if wh + wt:
        entries = min(wh + wt, max_buf)
        pos = [lo + e if e < wh else tail_lo + e - wh for e in range(entries)]
        sa = csa_lookup(csa, torch.tensor(pos, dtype=torch.int32,
                                          device=csa.samples.device)).cpu().numpy()
        prev = np.maximum(sa - sa % csa.sample_rate,
                          doc_starts[np.searchsorted(doc_starts, sa, "right") - 1])
        search = ceil_log2(int(csa.sampled.pos.shape[0]) + 1)
        per = ((sa - prev) * (search + csa.wm.levels) + search + 1
               + ceil_log2(len(doc_starts) + 1))
        per_thread = np.zeros(lanes)
        np.add.at(per_thread, np.arange(entries) % lanes, per)
        windows_ns = float(per_thread.max()) * lat["l1_ns"]

    def climb(leaf):
        c, node, nxt, steps = Chain(seen), leaf, leaf + 1, 0
        while True:
            nc = min(node, top)
            c.read(("parent_of", nc >> 5), ("is_first_child", nc >> 7))
            par = int(hp["parent_of"][nc])
            if not hp["is_first_child"][nc] or par < 0:
                break
            c.read(("next_leaf", max(par, 0) >> 5))
            nl = int(hp["next_leaf"][min(max(par, 0), max(hp["I"] - 1, 0))])
            if nl - 1 > rn:
                break
            node, nxt, steps = L + par, nl, steps + 1
        return node, nxt, steps, c

    def expand(nd, base):
        c = Chain(seen)
        c.read(("set_off", nd >> 5), ("set_off", (nd + 1) >> 5), ("doc_base", nd >> 5))
        ptr, end, stack, cnt, steps = int(so[nd]), int(so[nd + 1]), [], 0, 0
        for _ in range(hp["iter_cap"]):
            if not ((ptr < end or stack) and base + cnt < max_buf):
                break
            steps += 1
            if stack:
                sym = stack.pop()
            else:
                c.read(("A", ptr >> 5))
                sym, ptr = int(A[ptr]), ptr + 1
            if sym < d:
                cnt += 1
            else:
                r = min(max(sym - d - 1, 0), len(rl) - 1)
                c.read(("rule_right", r >> 5), ("rule_left", r >> 5))
                stack += [int(rr[r]), int(rl[r])]
        return steps, c

    def phase(chains):
        """The phase's slowest thread, in ns; its rounds counted, and every
        line the phase read marked seen for the next phases."""
        slow = max(chains, key=lambda c: c.ns(lat))
        rounds["l2_rounds"] += slow.l2
        rounds["l1_rounds"] += slow.l1
        for c in chains:
            seen.update(c.lines)
        return slow.ns(lat)

    shape = {"members": 0, "chunks": 0, "climb_steps": 0, "links": 0, "max_member_steps": 0,
             "expansion_phases": 0}
    head, end, cover_ns, held = ln, wh + wt, 0.0, []
    while True:
        if (head <= rn and shape["members"] < max_cover and end < max_buf
                and len(held) + lanes <= rounds_held * lanes):
            valid = min(lanes, rn - head + 1)
            climbs = [climb(leaf) for leaf in range(head, head + valid)]
            cover_ns += phase([c for *_, c in climbs])
            room = max_cover - shape["members"]
            if all(nxt == head + k + 1 for k, (_, nxt, _, _) in enumerate(climbs)):
                members = climbs[:min(valid, room)]
                head += len(members)
            else:
                members, leaf = [], head
                while leaf - head < valid and len(members) < room:
                    members.append(climbs[leaf - head])
                    leaf = members[-1][1]
                head = leaf
                shape["links"] += len(members)
                cover_ns += len(members) * lat["l1_ns"]
            lists = []
            for nd, *_ in members:
                lists.append(Chain(seen))
                lists[-1].read(("doc_base", nd >> 5), ("doc_base", (nd + 1) >> 5))
            cover_ns += phase(lists)
            for nd, *_ in members:
                held.append((nd, end))
                end += int(db[nd + 1] - db[nd])
            shape["chunks"] += 1
            shape["members"] += len(members)
            shape["climb_steps"] += sum(st for *_, st, _ in members)
            continue
        if not held:
            break
        expansions = [expand(nd, base) for nd, base in held]
        cover_ns += phase([c for _, c in expansions])
        shape["expansion_phases"] += 1
        shape["max_member_steps"] = max([shape["max_member_steps"]]
                                        + [st for st, _ in expansions])
        held = []
    rounds.update(head_ns=head_ns, windows_ns=windows_ns, cover_ns=cover_ns, cover=shape)
    return head_ns + windows_ns + cover_ns, rounds


def pdl_kernel_checks(full_svc, full_batches, topk, lat):
    """Phase 4, PDL gather: the kernel against its plain version bit for
    bit (buffer, frequencies, count) on phase 2's listing PDL and phase
    2b's top-k PDL, their batches' ranges (tf-idf's term ranges too) and
    edge ranges, at max_buf 4,096 and 64 and max_cover 1,024 and 4; every
    count held to the host replay of the cover.  Then timed at the main
    path's shape (phase 2, engine pdl, B = 32, max_buf 4,096)."""
    from repro_torch.kernels.pdl_gather import (
        GATHER_THREADS, PDL_ROUNDS, pdl_gather, pdl_gather_plain,
    )

    dev = full_svc.da.device
    tsvc = topk["svc"]
    full_ranges = []
    for batch in full_batches:
        plan = full_svc.plan(batch)
        full_ranges.append((torch.from_numpy(plan["lo"]).to(dev),
                            torch.from_numpy(plan["hi"]).to(dev)))
    no_sync_checks(full_svc, full_ranges[0], tsvc, topk["ranges"][0],
                   min(MAX_DF, full_svc.coll.d + 1))

    def edge(svc, pdl, lo0, hi0):
        """24 batch rows, then empty, inverted, whole and one-block ranges,
        and one range from inside the two largest leaves: windows of up to
        2 x (block_size - 1) positions."""
        n, b = svc.csa.n, pdl.block_size
        ls = pdl.leaf_starts.cpu().numpy()
        i, k = sorted(np.argsort(np.diff(ls))[-2:].tolist())
        elo = [0, 5, 7, 0, n - 1, 3, b + 1, 1, int(ls[i]) + 1]
        ehi = [0, 5, 3, n, n, b - 1, 2 * b - 2, n - 1, int(ls[k + 1]) - 1]
        t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        return torch.cat([lo0[:24], t(elo)]), torch.cat([hi0[:24], t(ehi)])

    configs = ((MAX_BUF, 1024), (64, 1024), (MAX_BUF, 4), (64, 4))
    cases = [("list PDL full batch 0, config " + str(c), full_svc.pdl_list, full_svc.csa,
              *full_ranges[0], c) for c in configs]
    cases += [(f"list PDL full batch {i}", full_svc.pdl_list, full_svc.csa, lo, hi, configs[0])
              for i, (lo, hi) in enumerate(full_ranges[1:], 1)]
    cases += [("list PDL edge ranges, config " + str(c), full_svc.pdl_list, full_svc.csa,
               *edge(full_svc, full_svc.pdl_list, *full_ranges[0]), c) for c in configs]
    for i, (lo, hi) in enumerate(topk["ranges"]):
        cases += [(f"top-k PDL batch {i}, config {c}", tsvc.pdl_topk, tsvc.csa, lo, hi, c)
                  for c in configs]
    cases += [(f"top-k PDL tf-idf terms {i}", tsvc.pdl_topk, tsvc.csa, lo, hi,
               (TFIDF_MAX_BUF, 1024)) for i, (lo, hi) in enumerate(topk["term_ranges"])]
    cases += [("top-k PDL edge ranges, config " + str(c), tsvc.pdl_topk, tsvc.csa,
               *edge(tsvc, tsvc.pdl_topk, *topk["ranges"][0]), c) for c in configs]
    host = {id(full_svc.pdl_list): pdl_host_arrays(full_svc.pdl_list),
            id(tsvc.pdl_topk): pdl_host_arrays(tsvc.pdl_topk)}
    mism, err, truncated = 0, 0, {"windows": 0, "expansion": 0, "cover": 0}
    for label, pdl, csa, lo, hi, (max_buf, max_cover) in cases:
        k = pdl_gather(pdl, csa, lo, hi, max_buf, max_cover)
        p = pdl_gather_plain(pdl, csa, lo, hi, max_buf, max_cover)
        mm = sum(int((x != y).sum()) for x, y in zip(k, p))
        mism += mm
        err = max([err] + [int((x.long() - y.long()).abs().max()) for x, y in zip(k, p)])
        count = k[2].cpu().numpy()
        for r, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
            entries, cut, windows = pdl_gather_entries(host[id(pdl)], a, b, max_cover)
            want = windows if windows >= max_buf else min(entries, max_buf)
            require(count[r] == want, (label, r, "count", int(count[r]), "replay", want))
            truncated["windows"] += windows > max_buf
            truncated["expansion"] += windows < max_buf < entries
            truncated["cover"] += bool(cut)
        log(f"[kernels] pdl_gather {label}: mismatches {mm}")
    require(mism == 0, ("pdl_gather mismatches", mism))
    require(all(v > 0 for v in truncated.values()), ("truncation not exercised", truncated))
    log(f"[kernels] pdl_gather rows truncated: {truncated}")

    # -- times at the main path's shape; the bound from this run's work
    pdl, csa = full_svc.pdl_list, full_svc.csa
    lo, hi = full_ranges[0]
    fk = lambda: pdl_gather(pdl, csa, lo, hi, MAX_BUF, 1024)  # noqa: E731
    fp = lambda: pdl_gather_plain(pdl, csa, lo, hi, MAX_BUF, 1024)  # noqa: E731
    kms, kdev = cuda_time_ms(fk, 20), queued_time_ms(fk, 20)
    kprof = device_ms_of(profile_calls(fk, 5), "pdl_gather_kernel")
    pms = cuda_time_ms(fp, 1)
    hp = host[id(pdl)]
    doc_starts = csa.doc_bv.pos.cpu().numpy()
    B = lo.shape[0]
    taken, window_total, paths = 0, 0, []
    for a, b in zip(lo.tolist(), hi.tolist()):
        entries, _, windows = pdl_gather_entries(hp, a, b, 1024)
        taken += windows if windows >= MAX_BUF else min(entries, MAX_BUF)
        window_total += min(windows, MAX_BUF)
        paths.append(pdl_walk_ns(hp, csa, doc_starts, a, b, MAX_BUF, 1024, lat, GATHER_THREADS,
                                 PDL_ROUNDS))
    lat_ns, rounds = max(paths, key=lambda x: x[0])
    log(f"[kernels] pdl_gather slowest query's path: {lat_ns / 1e3:.2f} us "
        f"(head {rounds['head_ns']:.0f} ns, windows {rounds['windows_ns']:.0f} ns, cover "
        f"{rounds['cover_ns']:.0f} ns); its cover: {json.dumps(rounds['cover'])}")
    nbytes = B * 8 + B * MAX_BUF * 8 + B * 4 + 4 * taken + 8 * window_total
    return [dict(
        name="pdl_gather", route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
        replaces="src/repro/core/pdl.py:461",
        replaces_note="no TPU kernel: the reference's _pdl_gather is XLA",
        launches=None, max_abs_err=err, mismatches=mism,
        ms=kms, kernel_ms=kms, device_ms=kdev, profiler_device_ms=kprof, plain_ms=pms,
        library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        latency_chain=rounds, latency_bound_ms=lat_ns * 1e-6,
        shape=f"B={B} max_buf={MAX_BUF} max_cover=1024 n={csa.n} L={pdl.L} I={pdl.I} "
              f"entries_taken={taken} window_entries={window_total}",
        topk_shape_ms=cuda_time_ms(lambda: pdl_gather(
            tsvc.pdl_topk, tsvc.csa, *topk["ranges"][0], MAX_BUF, 1024), 20),
        topk_shape_device_ms=queued_time_ms(lambda: pdl_gather(
            tsvc.pdl_topk, tsvc.csa, *topk["ranges"][0], MAX_BUF, 1024), 20),
        tfidf_shape_device_ms=queued_time_ms(lambda: pdl_gather(
            tsvc.pdl_topk, tsvc.csa, *topk["term_ranges"][0], TFIDF_MAX_BUF, 1024), 20),
    )]


def primitive_kernel_checks(svc, large, wm_args, lat):
    """Phase 4, rank and RMQ: each kernel against its plain version, bit for
    bit, on every wavelet level and both ILCP sparse tables of phases 2 and
    3 and on edge rows; then timed at the slice's shapes and on one stream
    of ``STREAM_Q`` queries."""
    from repro_torch.common import floor_log2, floor_log2_t
    from repro_torch.kernels.ilcp_list import runs_of
    from repro_torch.kernels.rank import rank, rank_plain
    from repro_torch.kernels.rmq import rmq, rmq_plain

    dev = svc.da.device
    gen = torch.Generator().manual_seed(1)
    mism, err = {"rank": 0, "rmq": 0}, {"rank": 0, "rmq": 0}

    def rand(hi_excl, q):
        return torch.randint(0, hi_excl, (q,), generator=gen, dtype=torch.int32).to(dev)

    def compare(name, k, p, label):
        mm = int((k != p).sum())
        mism[name] += mm
        err[name] = max(err[name], int((k.long() - p.long()).abs().max()) if k.numel() else 0)
        log(f"[kernels] {name} {label}: mismatches {mm}")

    def rmq_ranges(rho, q):
        """Random starts with spans of every scale, plus the edge rows:
        span 1, hi < lo, the whole array, and every power-of-two span."""
        lo = rand(rho, q)
        scale = rand(floor_log2(rho) + 1, q)
        hi = torch.clamp(lo + (rand(1 << 30, q) % (torch.ones_like(scale) << scale)), max=rho - 1)
        elo = [0, rho - 1, 0, min(7, rho - 1), rho - 1]
        ehi = [rho - 1, rho - 1, 0, min(3, rho - 1), 0]
        for p in range(floor_log2(rho) + 1):
            a = int(torch.randint(0, rho - (1 << p) + 1, (1,), generator=gen))
            elo.append(a)
            ehi.append(a + (1 << p) - 1)
        edge = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        return torch.cat([edge(elo), lo]), torch.cat([edge(ehi), hi.to(torch.int32)])

    def rmq_reads(vals, table, lo, hi):
        """(table cells, value cells, leftmost ties) a query batch reads."""
        levels, rho = table.shape
        k = torch.clamp(floor_log2_t(torch.clamp(hi - lo + 1, min=1)), 0, levels - 1).long()
        right = torch.maximum(hi - (1 << k) + 1, lo).long()
        ia, ib = table[k, lo.long()], table[k, right]
        cells = torch.unique(torch.cat([k * rho + lo.long(), k * rho + right])).numel()
        heads = torch.unique(torch.cat([ia, ib])).numel()
        return cells, heads, int(((ia != ib) & (vals[ia] == vals[ib])).sum())

    # -- bit for bit
    for label, wm in (("full", svc.csa.wm), ("large", large["csa"].wm)):
        n = wm.n
        edge = torch.tensor([0, 1, 31, 32, 33, 63, 64, n - 1, n], dtype=torch.int32, device=dev)
        for lvl in range(wm.levels):
            a = (wm.words[lvl], wm.ones_prefix[lvl], torch.cat([edge, rand(n + 1, 100_000)]))
            compare("rank", rank(*a), rank_plain(*a), f"{label} level {lvl} (Q=100,009)")
    ties = 0
    for label, ix in (("full", svc.ilcp), ("large", large["ilcp"])):
        lo, hi = rmq_ranges(ix.nruns, 100_000)
        a = (ix.vilcp, ix.rmq.table, lo, hi)
        compare("rmq", rmq(*a), rmq_plain(*a), f"{label} ILCP, rho={ix.nruns} (Q={lo.numel()})")
        ties += rmq_reads(*a)[2]
    require(mism == {"rank": 0, "rmq": 0}, mism)
    require(ties > 0, "no RMQ query met a leftmost tie between its two table reads")
    log(f"[kernels] rmq: {ties} queries resolved a tie between equal table minima")

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
        return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"

    def rank_timing(wm, idx, reps):
        a = (wm.words[0], wm.ones_prefix[0], idx)
        fk, fp = (lambda: rank(*a)), (lambda: rank_plain(*a))
        q = idx.numel()
        b_ms, b_by = bound(q * 8 + 8 * torch.unique(idx >> 5).numel(), q * 8)
        return dict(ms=cuda_time_ms(fk, reps), device_ms=queued_time_ms(fk, reps),
                    profiler_device_ms=device_ms_of(profile_calls(fk, 20), "rank_kernel"),
                    plain_ms=cuda_time_ms(fp, max(reps // 5, 2)),
                    bound_ms=b_ms, bound_by=b_by, q=q)

    def rmq_timing(ix, lo, hi, reps):
        a = (ix.vilcp, ix.rmq.table, lo, hi)
        fk, fp = (lambda: rmq(*a)), (lambda: rmq_plain(*a))
        q = lo.numel()
        cells, heads, _ = rmq_reads(*a)
        b_ms, b_by = bound(q * 12 + 4 * cells + 4 * heads, q * 16)
        return dict(ms=cuda_time_ms(fk, reps), device_ms=queued_time_ms(fk, reps),
                    profiler_device_ms=device_ms_of(profile_calls(fk, 20), "rmq_kernel"),
                    plain_ms=cuda_time_ms(fp, max(reps // 5, 2)),
                    bound_ms=b_ms, bound_by=b_by, q=q)

    # -- times: the slice's shapes (wm_rank_batch's level-0 stream [lo; hi] of
    # phase 3b; the first lockstep iteration's batch of 128 intervals), then
    # one stream of STREAM_Q queries over the large index
    wm, ix = large["csa"].wm, large["ilcp"]
    c, i = wm_args
    i = torch.from_numpy(i).to(dev)
    slice_rank = rank_timing(wm, torch.cat([torch.zeros_like(i), i]), 50)
    stream_rank = rank_timing(wm, rand(wm.n + 1, STREAM_Q), 10)
    lo, hi = large["ranges"][0]
    a_run = torch.clamp(runs_of(ix.run_starts, lo), 0, ix.nruns - 1).to(torch.int32)
    b_run = torch.clamp(runs_of(ix.run_starts, hi - 1), 0, ix.nruns - 1).to(torch.int32)
    slice_rmq = rmq_timing(ix, a_run.contiguous(), b_run.contiguous(), 50)
    stream_rmq = rmq_timing(ix, *(x[:STREAM_Q].contiguous() for x in rmq_ranges(ix.nruns, STREAM_Q)),
                            10)
    records = []
    # chains: the query's index read, then the word and prefix (rank); the
    # query's ends, then two table cells, then two values (RMQ); all L2
    for name, line, sl, st, chain in (
            ("rank", "src/repro/kernels/rank.py:39", slice_rank, stream_rank, 2),
            ("rmq", "src/repro/kernels/rmq.py:44", slice_rmq, stream_rmq, 3)):
        records.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
            replaces=line, launches=None, max_abs_err=err[name], mismatches=mism[name],
            ms=sl["ms"], kernel_ms=sl["ms"], device_ms=sl["device_ms"],
            profiler_device_ms=sl["profiler_device_ms"], plain_ms=sl["plain_ms"],
            library_ms=None, bound_ms=sl["bound_ms"], bound_by=sl["bound_by"],
            shape=f"Q={sl['q']} (large index, n={wm.n}, rho={ix.nruns})",
            stream_q=st["q"], stream_ms=st["ms"], stream_device_ms=st["device_ms"],
            stream_profiler_device_ms=st["profiler_device_ms"],
            stream_plain_ms=st["plain_ms"], stream_bound_ms=st["bound_ms"],
            stream_bound_by=st["bound_by"], latency_chain={"l2_rounds": chain, "l1_rounds": 0},
            latency_bound_ms=chain * lat["l2_ns"] * 1e-6,
        ))
    return records


def free_device_memory():
    """Drop cached blocks so the next phase starts from what is live."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps at each element's magnitude, the
    magnitude floored at 2^-8 of ``want``'s largest (near zero an ulp is no
    measure of a difference formed at the tensor's scale)."""
    g, w = got.float(), want.float()
    if w.numel() == 0:
        return 0.0
    mag = torch.clamp(w.abs(), min=max(float(w.abs().max()) * 2**-8, 1e-30))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def f32_params(params):
    return {k: f32_params(v) if isinstance(v, dict) else v.float() for k, v in params.items()}


def phase_lm(dev, fa, cfg, requests=LM_REQUESTS, long=LM_LONG, check_tokens=LM_CHECK_TOKENS,
             check_steps=LM_CHECK_STEPS):
    """Phase 5: prefill and greedy decode at full width, launch counts, and
    the f32 checks off the kernel path.  Returns the launches, the runs'
    numbers, per run layer 0's (q, k, v) for the kernel checks, and the
    f32 checks' largest differences."""
    import dataclasses

    from repro_torch.models.transformer import (
        _group_params, _qkv, forward_decode, forward_prefill, init_params,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers x d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} KV) x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{cfg.param_count():,} parameters, {nbytes / 1e9:.2f} GB in {cfg.param_dtype}; "
        f"init {time.perf_counter() - t0:.2f} s")
    qkv, runs, prompts, prefill_logits = {}, {}, {}, {}
    fa.launches = fa.hopper_launches = 0  # the LM serving path's run starts here
    for label, (B, S, steps) in (("requests", requests), ("long", long)):
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
        torch.cuda.reset_peak_memory_stats()
        before, hopper_before = fa.launches, fa.hopper_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = forward_prefill(cfg, params, tokens, max_seq=S + steps)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        require(fa.launches - before == cfg.n_layers,
                (label, "flash launches per prefill", fa.launches - before))
        require(fa.hopper_launches - hopper_before == cfg.n_layers,
                (label, "Hopper flash launches per bf16 prefill", fa.hopper_launches - hopper_before))
        require(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
                (label, "prefill logits"))
        prompts[label], prefill_logits[label] = tokens, logits.float()
        tok = logits.argmax(-1)
        step_ms = []
        for i in range(steps):
            before, hopper_before = fa.launches, fa.hopper_launches
            t0 = time.perf_counter()
            if i < steps - 1:
                logits, cache = forward_decode(cfg, params, tok, cache, S + i)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            else:  # the last step under the profiler (after one unprofiled run of
                # it, which writes the same cache entries): where a step's time goes
                out = {}

                def step(t=S + i):
                    out["logits"] = forward_decode(cfg, params, tok, cache, t)[0]

                prof = profile_calls(step, 1)
                logits = out["logits"]
            require(fa.launches == before and fa.hopper_launches == hopper_before,
                    (label, "flash launched in a decode step"))
        require(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
                (label, "decode logits"))
        top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:3]
        med = float(np.median(step_ms)) if step_ms else float("nan")
        runs[label] = dict(
            batch=B, prompt=S, steps=steps, prefill_s=prefill_s, prefill_tok_s=B * S / prefill_s,
            decode_step_ms=step_ms, decode_median_ms=med, decode_tok_s=B * 1e3 / med,
            last_step_wall_ms=prof["wall_ms"], last_step_device_ms=prof["device_ms"],
            last_step_activities=prof["kernels_per_call"],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"[lm] {label}: {B} x {S} tokens, prefill {prefill_s:.3f} s "
            f"({B * S / prefill_s:,.0f} tokens/s); {steps} decode steps, median "
            f"{med:.2f} ms per step, one token per prompt ({B * 1e3 / med:,.1f} tokens/s; steps "
            + " ".join(f"{x:.1f}" for x in step_ms) + f" ms); last step profiled: wall "
            f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']} ms in "
            f"{prof['kernels_per_call']:.0f} device activities, top "
            + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top)
            + f"; peak device memory {runs[label]['peak_gib']:.2f} GiB")
        del logits, cache
        # layer 0's attention inputs of this run, for the kernel check
        x = params["embed"][tokens].to(cfg.act_dtype)
        p0 = _group_params(params["blocks"]["pos0"], 0)
        qkv[label] = _qkv(cfg, 0, p0, x, torch.arange(S, device=dev)[None, :])
        del x
    launches = {"flash_attention": fa.launches}
    hopper_launches = fa.hopper_launches
    require(hopper_launches == fa.launches, ("flash launches off the Hopper kernel",
                                             fa.launches, hopper_launches))
    # the same prompts through the SIMT kernel (route forced in the model's
    # call, after the counted run): how far the two kernels' bf16 logits lie
    # apart.  Reported, not held to a bound: bf16 activations through 28
    # layers amplify one-ulp attention differences.
    import functools

    import repro_torch.models.transformer as transformer

    hopper_fa = transformer.flash_attention
    transformer.flash_attention = functools.partial(hopper_fa, route="simt")
    try:
        for label, tokens in prompts.items():
            simt_logits, _ = forward_prefill(cfg, params, tokens)
            gap = max_abs(prefill_logits[label], simt_logits)
            runs[label]["bf16_logits_gap_hopper_vs_simt"] = gap
            log(f"[lm] {label}: bf16 last-token logits, Hopper kernel vs SIMT kernel, max |diff| "
                f"{gap:.3e} (max |logit| {float(simt_logits.abs().max()):.3f})")
            del simt_logits
    finally:
        transformer.flash_attention = hopper_fa
    del prefill_logits
    # where a prefill's time goes: the requests prompt once more, profiled
    B, S, _ = requests
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    prof = profile_calls(lambda: forward_prefill(cfg, params, tokens), 1)
    flash_ms = device_ms_of(prof, "flash_hopper_kernel")
    top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:5]
    runs["requests"].update(profiled_prefill_wall_ms=prof["wall_ms"],
                            profiled_prefill_device_ms=prof["device_ms"],
                            profiled_prefill_flash_ms=flash_ms)
    log(f"[lm] requests prefill profiled: wall {prof['wall_ms']:.2f} ms, device "
        f"{prof['device_ms']} ms in {prof['kernels_per_call']:.0f} device activities, flash "
        f"kernel {flash_ms} ms; top " + "; ".join(f"{k[:48]} {v:.3f}" for k, v in top))

    # checks off the kernel path, in f32 (no TF32: torch's default matmul
    # precision on CUDA is full f32)
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    p32 = f32_params(params)
    del params
    free_device_memory()
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32, act_dtype=torch.float32)
    T = check_tokens
    tokens = torch.randint(0, cfg.vocab, (1, T + check_steps), generator=gen, device=dev)
    flash, cache = forward_prefill(c32, p32, tokens[:, :T], max_seq=T + check_steps)
    xla, _ = forward_prefill(dataclasses.replace(c32, attention_impl="xla"), p32, tokens[:, :T])
    err_xla = max_abs(flash, xla)
    log(f"[lm] f32, 1 x {T}: flash path vs xla path, last-token logits max |diff| "
        f"{err_xla:.3e} (max |logit| {float(xla.abs().max()):.3f}, tolerance {LM_F32_TOL})")
    require(err_xla <= LM_F32_TOL, ("flash vs xla logits", err_xla))
    errs = []
    for i in range(check_steps):
        dec, cache = forward_decode(c32, p32, tokens[:, T + i], cache, T + i)
        pre, _ = forward_prefill(c32, p32, tokens[:, :T + i + 1])
        errs.append(max_abs(dec, pre))
    log(f"[lm] f32 decode steps vs forward_prefill of the tokens so far, max |diff| per step "
        + " ".join(f"{e:.3e}" for e in errs) + f" (tolerance {LM_F32_TOL})")
    require(max(errs) <= LM_F32_TOL, ("decode vs prefill logits", errs))
    del p32, cache
    free_device_memory()
    return launches, runs, qkv, {"f32_flash_vs_xla": err_xla, "f32_decode_vs_prefill": max(errs),
                                 "hopper_launches": hopper_launches}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def flash_flops(B, H, S_q, S_kv, Dh, causal):
    """The function's flops: 2*B*H*S_q*S_kv*Dh for causal attention (half
    of QK^T and PV), twice that for full attention."""
    return 2 * B * H * S_q * S_kv * Dh * (1 if causal else 2)


def flash_bound(B, H, H_kv, S_q, S_kv, Dh, causal, dtype, flop_factor=1.0):
    """(ms, "bytes"/"operations"): ``flop_factor`` times the function's
    flops at the dtype's peak, or q, k, v and o once over HBM."""
    flops = flop_factor * flash_flops(B, H, S_q, S_kv, Dh, causal)
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * Dh * (2 * B * H * S_q + 2 * B * H_kv * S_kv)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    tb, to = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


#: the Hopper kernel's tensor work: QK^T once and PV twice (split P)
SPLIT_P_FLOP_FACTOR = 1.5


def flash_kernel_checks(dev, qkv, reps=(20, 3)):
    """Both flash kernels against the plain version on phase 5's real inputs
    and on edge shapes: every bf16 operand that ``flash_route`` sends to
    the Hopper kernel also through the SIMT kernel, f32 through the SIMT
    kernel; a view TMA cannot take goes to the SIMT kernel and raises only
    where the Hopper kernel is asked for by name.  Times of both kernels at
    phase 5's two shapes beside SDPA and the bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_route,
    )

    fa = flash_attention
    worst = {"f32": 0.0, "bf16_abs": 0.0, "bf16_ulps": 0.0, "simt_bf16_ulps": 0.0}

    def check(q, k, v, causal, label):
        want = flash_attention_plain(q, k, v, causal=causal)
        routes = ("hopper", "simt") if flash_route(q, k, v) == "hopper" else ("simt",)
        for route in routes:
            before, hopper_before = fa.launches, fa.hopper_launches
            got = fa(q, k, v, causal=causal, route=route)
            require((fa.launches - before, fa.hopper_launches - hopper_before)
                    == (1, int(route == "hopper")), (label, route, "launch counts"))
            err = max_abs(got, want)
            require(bool(torch.isfinite(got).all()), (label, route, "non-finite output"))
            if q.dtype == torch.float32:
                ok = torch.allclose(got, want, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)
                worst["f32"] = max(worst["f32"], err)
                log(f"[flash] {label} {route}: max |diff| {err:.3e}")
                require(ok, (label, route, "flash kernel != plain version", err))
            else:
                u = bf16_ulps(got, want)
                key = "bf16_ulps" if route == "hopper" else "simt_bf16_ulps"
                worst["bf16_abs"], worst[key] = max(worst["bf16_abs"], err), max(worst[key], u)
                log(f"[flash] {label} {route}: max |diff| {err:.3e}, {u:.2f} bf16 ulps")
                require(u <= BF16_ULPS, (label, route, "flash kernel beyond 2 bf16 ulps", u))
        return routes

    views = {}
    for label, (q, k, v) in qkv.items():
        views[label] = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        B, S, H, Dh = q.shape
        routes = check(*views[label], True, f"layer 0 of the {label} run, B={B} S={S} bf16")
        require(routes[0] == "hopper", (label, "phase 5's q/k/v are not routed to Hopper"))
    gen = torch.Generator(device=dev).manual_seed(2)
    for (B, H, H_kv, S_q, S_kv, Dh, causal) in (
            (2, 4, 2, 128, 128, 16, True), (1, 9, 3, 200, 200, 64, True),
            (2, 4, 4, 77, 333, 128, True), (1, 2, 2, 100, 300, 128, False),
            (1, 6, 2, 129, 129, 128, False), (1, 24, 8, 1000, 1000, 128, True),
            (1, 3, 1, 1, 70, 64, True)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, h, s, Dh, generator=gen, device=dev).mul_(0.5).to(dtype)
                       for h, s in ((H, S_q), (H_kv, S_kv), (H_kv, S_kv)))
            routes = check(q, k, v, causal, f"B={B} H={H} H_kv={H_kv} S_q={S_q} S_kv={S_kv} "
                           f"Dh={Dh} {'causal' if causal else 'full'} {str(dtype)[6:]}")
            require(routes[0] == ("hopper" if dtype == torch.bfloat16 else "simt"),
                    ("route of", B, H, S_q, Dh, dtype, routes))
    # a bf16 view TMA cannot take (base address 2 bytes past a 16-byte
    # boundary): the route says "simt", the wrapper runs the SIMT kernel, and
    # only an explicit request for the Hopper kernel raises
    base = torch.randn(1, 4, 200, 136, generator=gen, device=dev).mul_(0.5).bfloat16()
    shifted = base[..., 1:129]
    require(flash_route(shifted, shifted, shifted) == "simt", "misaligned view routed to Hopper")
    check(shifted, shifted, shifted, True, "misaligned bf16 view, S=200 Dh=128")
    wide, q = torch.zeros(1, 2, 8, 136, device=dev), torch.zeros(1, 2, 8, 64, device=dev)
    for bad, kw, what in (((wide, wide, wide), {}, "head dim 136"),
                          ((q, q[:, :, :4], q[:, :, :4]), {}, "causal S_kv < S_q"),
                          ((shifted, shifted, shifted), {"route": "hopper"},
                           "a misaligned view on the Hopper kernel")):
        before = (fa.launches, fa.hopper_launches)
        try:
            fa(*bad, causal=True, **kw)
        except ValueError:
            pass
        else:
            require(False, ("flash_attention took", what))
        require((fa.launches, fa.hopper_launches) == before, ("launched on", what))

    records = {}
    for label, n in zip(("requests", "long"), reps):
        qt, kt, vt = views[label]
        B, H, S, Dh = qt.shape
        H_kv = kt.shape[1]
        fk = lambda: fa(qt, kt, vt, causal=True)  # noqa: E731
        fs = lambda: fa(qt, kt, vt, causal=True, route="simt")  # noqa: E731
        fp = lambda: flash_attention_plain(qt, kt, vt, causal=True)  # noqa: E731
        fl = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                    enable_gqa=True)
        lib_err = max_abs(fk(), fl())
        b_ms, b_by = flash_bound(B, H, H_kv, S, S, Dh, True, qt.dtype)
        split_ms, _ = flash_bound(B, H, H_kv, S, S, Dh, True, qt.dtype, SPLIT_P_FLOP_FACTOR)
        flops = flash_flops(B, H, S, S, Dh, True)
        r = records[label] = dict(
            ms=cuda_time_ms(fk, n), device_ms=queued_time_ms(fk, n),
            profiler_device_ms=device_ms_of(profile_calls(fk, 2), "flash_hopper_kernel"),
            simt_ms=cuda_time_ms(fs, max(n // 4, 1)), simt_device_ms=queued_time_ms(fs, max(n // 4, 1)),
            plain_ms=cuda_time_ms(fp, max(n // 5, 1)), library_ms=cuda_time_ms(fl, n),
            library_device_ms=queued_time_ms(fl, n),
            bound_ms=b_ms, bound_by=b_by, split_p_bound_ms=split_ms, flops=flops,
            library_max_abs_diff=lib_err,
            shape=f"B={B} H={H} H_kv={H_kv} S_q=S_kv={S} Dh={Dh} causal bf16")
        for key in ("device_ms", "simt_device_ms", "library_device_ms"):
            r[key.replace("device_ms", "tflops")] = flops / r[key] / 1e9
        log(f"[flash] {label} shape: Hopper kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, "
            f"{r['tflops']:.1f} TFLOP/s; profiler {r['profiler_device_ms']}), SIMT kernel "
            f"{r['simt_ms']:.3f} ms (device {r['simt_device_ms']:.3f} ms, {r['simt_tflops']:.1f} "
            f"TFLOP/s), plain {r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.4f} ms (device "
            f"{r['library_device_ms']:.4f} ms, {r['library_tflops']:.1f} TFLOP/s), bound "
            f"{b_ms:.4f} ms ({b_by}; split P {split_ms:.4f} ms); Hopper kernel vs SDPA max "
            f"|diff| {lib_err:.3e}")
    main = records["requests"]
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_hopper.cu",
        replaces="src/repro/kernels/flash_attention.py:94", launches=None,
        flash_route="hopper", simt_source="src/repro_torch/csrc/model_kernels.cu",
        max_abs_err=max(worst["f32"], worst["bf16_abs"]), max_f32_err=worst["f32"],
        max_bf16_ulps=worst["bf16_ulps"], simt_max_bf16_ulps=worst["simt_bf16_ulps"],
        kernel_ms=main["ms"], library="torch.nn.functional.scaled_dot_product_attention("
                                     "is_causal=True, enable_gqa=True)",
        **main, **{f"long_{k}": v for k, v in records["long"].items()})


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| in f64 (f32 leaves)."""
    g, w = got.double(), want.double()
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))


def phase_train(dev, fa, cfg, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                check_tokens=TRAIN_CHECK_TOKENS, cli_steps=TRAIN_CLI_STEPS):
    """Phase 10: LM training at full width.  (a) ``steps`` bf16 AdamW steps
    through ``train``, flash launches per step, finite losses, the loss of
    step 1's batch after the last step; (b) the f32 flash step's loss and
    gradients against the "xla" step's, then the Function's dq/dk/dv on
    layer 0's q/k/v of (a) against autograd through the plain version;
    (c) recovery after an injected failure, a checkpoint round trip bit for
    bit, compressed training; (d) the CLI; (e) step time, memory, the flash
    forward and the VJP inside a profiled step.  Returns the launches of
    (a) and the numbers."""
    import dataclasses
    import itertools

    from repro_torch.data.pipelines import lm_batches
    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_attention_vjp
    from repro_torch.models.transformer import _group_params, _qkv, forward_train, init_params
    from repro_torch.train.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.train.loop import FailureInjector, train, train_with_recovery, value_and_grad
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, opt_state_shapes
    from repro_torch.train.tree import flatten, map_leaves

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    B, S = batch
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[train] {cfg.name}: {cfg.n_layers} layers x d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} KV) x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied "
        f"{cfg.tie_embeddings}; {cfg.param_count():,} parameters, {nbytes / 1e9:.3f} GB in "
        f"{cfg.param_dtype}; {B} x {S} tokens a step, attention {cfg.attention_impl}")
    batches = list(itertools.islice(lm_batches(cfg.vocab, B, S, seed=0), steps))

    def loss_fn(p, b, c=cfg):
        return forward_train(c, p, b["tokens"], b["labels"])

    marks = []

    def batch_fn(step):
        marks.append((fa.launches, fa.hopper_launches))
        return batches[step]

    runs = {"batch": B, "seq": S, "steps": steps, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the main path: the counts start here and are read after train
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.hopper_launches = 0
        t0 = time.perf_counter()
        base = train(loss_fn, lambda: params, batch_fn, n_steps=steps,
                     ckpt_dir=os.path.join(tmp, "base"), ckpt_every=TRAIN_CKPT_EVERY, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        marks.append((fa.launches, fa.hopper_launches))
        launches = {"flash_attention": fa.launches}
        per_step = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(len(base.losses) == steps and all(np.isfinite(base.losses)),
                ("training losses", base.losses))
        require(per_step == [(2 * cfg.n_layers, 2 * cfg.n_layers)] * steps,
                ("flash launches (all, Hopper) per training step", per_step))
        med = float(np.median(base.step_seconds[1:]))
        runs.update(losses=base.losses, step_seconds=base.step_seconds, step_median_s=med,
                    tokens_per_s=B * S / med, peak_gib=peak, run_s=run_s,
                    flash_launches_per_step=per_step[0][0], stragglers=base.straggler_steps)
        log(f"[train] (a) {steps} steps in {run_s:.2f} s (checkpoints at "
            f"{TRAIN_CKPT_EVERY} and {steps} included): losses "
            + " ".join(f"{x:.4f}" for x in base.losses)
            + "; step s " + " ".join(f"{x:.3f}" for x in base.step_seconds)
            + f"; median of steps 2-{steps} {med:.4f} s ({B * S / med:,.0f} tokens/s); flash "
            f"launches per step {per_step[0][0]} ({per_step[0][1]} Hopper); peak device memory "
            f"{peak:.2f} GiB; {card}")
        # the last step's checkpoint: the loss of step 1's batch has fallen
        step_n, path = latest_checkpoint(os.path.join(tmp, "base"))
        require(step_n == steps, ("last checkpoint", step_n))
        state, _ = restore_checkpoint(path, {"params": params, "opt": opt_state_shapes(params)},
                                      device=dev)
        trained = state["params"]
        with torch.no_grad():
            again = float(loss_fn(trained, {k: torch.as_tensor(v, device=dev)
                                            for k, v in batches[0].items()}))
        runs["loss_step1_batch_after"] = again
        log(f"[train] loss of step 1's batch: {base.losses[0]:.4f} at step 1, {again:.4f} after "
            f"step {steps}")
        require(again < base.losses[0], ("loss did not fall on a repeated batch", again))

        # (e) one step profiled, on the trained state
        opt_cfg = AdamWConfig()
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}

        def one_step():
            loss, grads = value_and_grad(loss_fn, trained, tb)
            adamw_update(opt_cfg, trained, grads, state["opt"])
            return float(loss)

        prof = profile_calls(one_step, 1)
        flash_ms = device_ms_of(prof, "flash_hopper_kernel")
        top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:6]
        busy = prof["device_ms"] / prof["wall_ms"] if prof["device_ms"] else None
        runs.update(profiled_step_wall_ms=prof["wall_ms"],
                    profiled_step_device_ms=prof["device_ms"],
                    profiled_step_activities=prof["kernels_per_call"], busy_share=busy,
                    flash_fwd_device_ms_per_launch=None if flash_ms is None
                    else flash_ms / (2 * cfg.n_layers),
                    top_device_ms={k[:80]: v for k, v in top})
        log(f"[train] one step profiled: wall {prof['wall_ms']:.2f} ms, device "
            f"{prof['device_ms']} ms in {prof['kernels_per_call']:.0f} device activities (busy "
            f"share {busy}); flash kernel {flash_ms} ms over {2 * cfg.n_layers} launches; top "
            + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top) + f"; {card}")
        del trained, state, tb

        # (c) a checkpoint round trip at full width, bit for bit
        sample = {"params": params, "opt": {
            "m": map_leaves(lambda p: p.float() * 2, params),
            "v": map_leaves(lambda p: p.float() * p.float(), params),
            "step": torch.tensor(steps, dtype=torch.int32, device=dev)}}
        back, step_back = restore_checkpoint(save_checkpoint(os.path.join(tmp, "rt"), 7, sample),
                                             sample, device=dev)
        same = [torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
                and a.dtype == b.dtype and a.shape == b.shape
                for a, b in zip(flatten(sample)[0], flatten(back)[0])]
        require(step_back == 7 and all(same), "checkpoint round trip not bit-identical")
        log(f"[train] checkpoint round trip: {len(same)} leaves bit-identical")
        del sample, back
        shutil.rmtree(os.path.join(tmp, "rt"))

        # (c) recovery: fail at step TRAIN_FAIL_AT, resume from the checkpoint before it
        failure = FailureInjector(fail_at_step=TRAIN_FAIL_AT)
        rec = train_with_recovery(loss_fn, lambda: params, lambda s: batches[s], n_steps=steps,
                                  ckpt_dir=os.path.join(tmp, "rec"), ckpt_every=TRAIN_CKPT_EVERY,
                                  failure=failure, device=dev)
        resumed_from = steps - len(rec.losses)
        gap = max(abs(a - b) for a, b in zip(rec.losses, base.losses[resumed_from:]))
        runs.update(resume_gap=gap, resumed_from=resumed_from, restarts=rec.restarts)
        log(f"[train] (c) recovery: failure at step {TRAIN_FAIL_AT} fired {failure.fired}, "
            f"resumed from step {resumed_from}, {rec.restarts} restarts, losses "
            + " ".join(f"{x:.4f}" for x in rec.losses)
            + f"; max |diff| against the uninterrupted run {gap:.3e} "
            f"(tolerance {TRAIN_RESUME_TOL})")
        require(failure.fired and rec.final_step == steps
                and resumed_from == TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY,
                ("recovery", failure.fired, rec.final_step, resumed_from))
        require(gap <= TRAIN_RESUME_TOL, ("resumed losses", gap))
        shutil.rmtree(os.path.join(tmp, "rec"))

        # (c) compressed gradients
        comp = train(loss_fn, lambda: params, lambda s: batches[s], n_steps=steps,
                     ckpt_dir=os.path.join(tmp, "comp"), ckpt_every=TRAIN_CKPT_EVERY,
                     compress_grads=True, device=dev)
        w = steps // 2
        parity = abs(float(np.mean(comp.losses[-w:])) - float(np.mean(base.losses[-w:])))
        runs.update(compressed_losses=comp.losses, compressed_parity=parity,
                    compressed_max_step_gap=max(abs(a - b) for a, b in zip(comp.losses,
                                                                         base.losses)))
        log("[train] (c) int8 compressed: losses " + " ".join(f"{x:.4f}" for x in comp.losses)
            + f"; mean of the last {w} against uncompressed |diff| {parity:.4f} (bound "
            f"{TRAIN_PARITY_BOUND}), largest step gap {runs['compressed_max_step_gap']:.4f}")
        require(parity < TRAIN_PARITY_BOUND, ("compressed training parity", parity))

    # (b) the Function's gradients on layer 0's q/k/v of (a), against autograd
    # through the plain version (bf16, Hopper forward); its VJP timed
    x = params["embed"][torch.as_tensor(batches[0]["tokens"], device=dev)].to(cfg.act_dtype)
    q, k, v = _qkv(cfg, 0, _group_params(params["blocks"]["pos0"], 0), x,
                   torch.arange(S, device=dev)[None, :])
    del x
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    g = torch.randn(qt.shape, generator=gen, device=dev).to(qt.dtype)
    ops = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    got = torch.autograd.grad(fa(*ops, causal=True), ops, g)
    want = torch.autograd.grad(flash_attention_plain(*ops, causal=True), ops, g)
    vjp_ulps = max(bf16_ulps(a, b) for a, b in zip(got, want))
    vjp_abs = max(max_abs(a, b) for a, b in zip(got, want))
    del got, want, ops
    vjp_ms = cuda_time_ms(lambda: flash_attention_vjp(qt, kt, vt, g, causal=True), 3)
    runs.update(vjp_ms_per_layer=vjp_ms, vjp_max_bf16_ulps=vjp_ulps, vjp_max_abs=vjp_abs)
    log(f"[train] (b) Function dq/dk/dv on layer 0, B={B} S={S} bf16, against autograd through "
        f"the plain version: max |diff| {vjp_abs:.3e}, {vjp_ulps:.2f} bf16 ulps (tolerance "
        f"{BF16_ULPS}); recompute VJP {vjp_ms:.3f} ms per layer; {card}")
    require(vjp_ulps <= BF16_ULPS, ("flash VJP beyond 2 bf16 ulps", vjp_ulps))
    del q, k, v, qt, kt, vt, g

    # (b) f32 at full width on 1 x check_tokens: the flash step (SIMT kernel
    # and the Function's VJP) against the "xla" step, plain autograd
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    p32 = f32_params(params)
    del params
    free_device_memory()
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32, act_dtype=torch.float32)
    tokens = torch.as_tensor(batches[0]["tokens"][:1, :check_tokens], device=dev)
    b32 = {"tokens": tokens, "labels": tokens}
    before, hopper_before = fa.launches, fa.hopper_launches
    loss_f, grads_f = value_and_grad(lambda p, b: loss_fn(p, b, c32), p32, b32)
    require((fa.launches - before, fa.hopper_launches - hopper_before) == (2 * cfg.n_layers, 0),
            ("f32 flash step launches (all, Hopper)", fa.launches - before))
    xla = dataclasses.replace(c32, attention_impl="xla")
    loss_x, grads_x = value_and_grad(lambda p, b: loss_fn(p, b, xla), p32, b32)
    loss_rel = abs(float(loss_f) - float(loss_x)) / abs(float(loss_x))
    leaves_f, paths = flatten(grads_f)
    errs = {"/".join(pth): rel_norm(a, b) for pth, a, b in zip(paths, leaves_f,
                                                              flatten(grads_x)[0])}
    worst = max(errs, key=errs.get)
    runs.update(f32_loss_rel=loss_rel, f32_grad_rel=errs)
    log(f"[train] (b) f32, 1 x {check_tokens}: flash step vs xla step, loss {float(loss_f):.6f} vs "
        f"{float(loss_x):.6f} (relative {loss_rel:.2e}, tolerance {TRAIN_LOSS_RTOL}); gradient "
        f"relative norms " + ", ".join(f"{p} {e:.2e}" for p, e in errs.items())
        + f" (worst {worst}; tolerance {TRAIN_GRAD_RTOL})")
    require(loss_rel <= TRAIN_LOSS_RTOL, ("f32 flash vs xla loss", loss_rel))
    require(all(e <= TRAIN_GRAD_RTOL for e in errs.values()), ("f32 flash vs xla gradients", worst))
    for name in ("wq", "wk", "wv"):
        require(float(grads_f["blocks"]["pos0"][name].abs().max()) > 0, (name, "no gradient"))
    del p32, grads_f, grads_x
    free_device_memory()

    # (d) the CLI
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m",
             "--steps", str(cli_steps), "--ckpt", ckpt, *TRAIN_CLI_ARGS],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, ("training CLI", out.returncode, out.stderr[-2000:]))
    line = out.stdout.strip().splitlines()[-1]
    require(line.startswith(f"[smollm-135m] steps={cli_steps} loss "), ("CLI output", line))
    runs["cli_s"] = time.perf_counter() - t0
    log(f"[train] (d) python -m repro_torch.launch.train --arch smollm-135m --steps {cli_steps}: "
        f"exit 0 in {runs['cli_s']:.1f} s; {line}")
    runs["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase body {runs['phase_s']:.1f} s; {nvidia_smi_line()}")
    return launches, runs


#: device-time classes of a profiled LM prefill: substrings of kernel names
PROFILE_CLASSES = {
    "flash": ("flash",),
    "gemm": ("gemm", "nvjet", "xmma", "cutlass", "cublas"),
    "moe_sort": ("sort", "radix"),
    "scatter_gather": ("index", "scatter", "gather"),
}


def device_ms_by_class(prof: dict) -> dict:
    """A profile's device ms per call by ``PROFILE_CLASSES`` (the first
    class whose substring a kernel's lower-cased name holds), the others
    under ``rest``."""
    out = dict.fromkeys([*PROFILE_CLASSES, "rest"], 0.0)
    for name, ms in prof["by_kernel_ms"].items():
        low = name.lower()
        key = next((c for c, subs in PROFILE_CLASSES.items() if any(x in low for x in subs)),
                   "rest")
        out[key] += ms
    return out


@contextlib.contextmanager
def recorded_routes(transformer):
    """Every ``Route`` the model's MoE layers make inside the block, in
    call order (a recording stand-in for ``transformer._route``)."""
    routes, route = [], transformer._route

    def recording(*a):
        r = route(*a)
        routes.append(r)
        return r

    transformer._route = recording
    try:
        yield routes
    finally:
        transformer._route = route


def route_differences(got, want) -> list:
    """Per MoE layer whose routing differs (a token's expert or whether it
    is kept): (layer, first tokens, their top-2 gate margins in ``want``)."""
    out = []
    for layer, (a, b) in enumerate(zip(got, want)):
        bad = ((a.top != b.top) | (a.kept() != b.kept())).nonzero().flatten()
        if bad.numel():
            g = b.gate[bad].sort(dim=-1).values
            out.append((layer, bad[:8].tolist(), (g[:8, -1] - g[:8, -2]).tolist()))
    return out


def phase_llama4(dev, fa, cfg, runs=L4_RUNS, check_tokens=L4_CHECK_TOKENS,
                 decode_check=L4_DECODE_CHECK, cli_steps=L4_CLI_STEPS):
    """Phase 11: Llama 4 serving at full width (``cfg``: its depth cut).
    (a), (b): prefill and greedy decode per entry of ``runs``, launches,
    drops, times; one prefill of the first run profiled; (d) the Hopper
    kernel on layer 0's chunked-local and layer 3's global q/k/v of it; (c)
    the f32 checks on one group; (e) the training CLI.  Returns the
    launches of (a) and (b) and the numbers."""
    import dataclasses

    import torch.nn.functional as F

    import repro_torch.models.transformer as transformer
    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_route
    from repro_torch.models.transformer import (
        forward_decode, forward_prefill, init_params, moe_capacity,
    )

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    E = cfg.moe.n_experts
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    out = {"card": card, "layers": cfg.n_layers, "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(), "param_gb": nbytes / 1e9}
    log(f"[llama4] {cfg.name}: {cfg.n_layers} layers ({cfg.n_groups} groups: local positions "
        f"{cfg.local_positions} of {cfg.period}, chunk {cfg.local_chunk}) x d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV) x {cfg.head_dim}, {E} experts of d_ff "
        f"{cfg.moe.d_ff_expert or cfg.d_ff} + shared, vocab {cfg.vocab}; {cfg.param_count():,} "
        f"parameters ({cfg.active_param_count():,} active a token), {nbytes / 1e9:.2f} GB in "
        f"{cfg.param_dtype}; init {time.perf_counter() - t0:.2f} s; {card}")
    prompts = {}
    fa.launches = fa.hopper_launches = 0  # the Llama 4 serving path's run starts here
    for label, (B, S, steps) in runs.items():
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
        prompts[label] = tokens
        torch.cuda.reset_peak_memory_stats()
        before, hopper_before = fa.launches, fa.hopper_launches
        with recorded_routes(transformer) as routes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = forward_prefill(cfg, params, tokens, max_seq=S + steps)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        require((fa.launches - before, fa.hopper_launches - hopper_before)
                == (cfg.n_layers, cfg.n_layers),
                (label, "flash launches (all, Hopper) per prefill", fa.launches - before,
                 fa.hopper_launches - hopper_before))
        require(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
                (label, "prefill logits"))
        require(len(routes) == cfg.n_layers, (label, "routed layers", len(routes)))
        cap = moe_capacity(cfg, B * S)
        dropped = [int((~r.keep).sum()) for r in routes]
        busiest = [int(torch.bincount(r.top, minlength=E).max()) for r in routes]
        del routes
        tok = logits.argmax(-1)
        step_ms = []
        for i in range(steps):
            before, hopper_before = fa.launches, fa.hopper_launches
            t0 = time.perf_counter()
            logits, cache = forward_decode(cfg, params, tok, cache, S + i)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            require(fa.launches == before and fa.hopper_launches == hopper_before,
                    (label, "flash launched in a decode step"))
        require(logits.shape == (B, cfg.vocab) and bool(torch.isfinite(logits).all()),
                (label, "decode logits"))
        med = float(np.median(step_ms))
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[label] = dict(
            batch=B, prompt=S, steps=steps, capacity=cap, prefill_s=prefill_s,
            prefill_tok_s=B * S / prefill_s, decode_step_ms=step_ms, decode_median_ms=med,
            decode_tok_s=B * 1e3 / med, peak_gib=peak, dropped_per_layer=dropped,
            busiest_expert_tokens=busiest)
        log(f"[llama4] ({label}) {B} x {S} tokens: prefill {prefill_s:.3f} s "
            f"({B * S / prefill_s:,.0f} tokens/s), {cfg.n_layers} flash launches, all Hopper; "
            f"{steps} decode steps from t = {S} (t // chunk = {S // cfg.local_chunk}), median "
            f"{med:.2f} ms a step ({B * 1e3 / med:,.1f} tokens/s; steps "
            + " ".join(f"{x:.1f}" for x in step_ms) + f" ms), no flash launch; capacity {cap} "
            f"of {B * S} tokens over {E} experts: dropped per layer {dropped}, busiest expert's "
            f"tokens {busiest}; peak device memory {peak:.2f} GiB")
        del logits, cache
    launches = {"flash_attention": fa.launches}
    require(fa.hopper_launches == fa.launches, ("flash launches off the Hopper kernel",
                                                fa.launches, fa.hopper_launches))

    # where a prefill's time goes: the first run's prompt once more, profiled
    first = next(iter(runs))
    prof = profile_calls(lambda: forward_prefill(cfg, params, prompts[first]), 1)
    split = device_ms_by_class(prof)
    busy = prof["device_ms"] / prof["wall_ms"] if prof["device_ms"] else None
    top = sorted(prof["by_kernel_ms"].items(), key=lambda kv: -kv[1])[:8]
    out[first].update(profiled_prefill_wall_ms=prof["wall_ms"],
                      profiled_prefill_device_ms=prof["device_ms"], busy_share=busy,
                      profiled_prefill_activities=prof["kernels_per_call"],
                      device_ms_by_class=split, top_device_ms={k[:80]: v for k, v in top})
    log(f"[llama4] ({first}) prefill profiled: wall {prof['wall_ms']:.2f} ms, device "
        f"{prof['device_ms']} ms in {prof['kernels_per_call']:.0f} device activities (busy share "
        f"{busy}); device ms by class " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + "; top " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top) + f"; {card}")

    # (d) the Hopper kernel on layer 0's chunked-local and layer 3's global
    # q/k/v of the first run (taken from one more prefill, after the counts)
    captured, model_fa = [], transformer.flash_attention

    def capture(q, k, v, **kw):
        if len(captured) < cfg.period:
            captured.append((q, k, v))
        return model_fa(q, k, v, **kw)

    transformer.flash_attention = capture
    try:
        forward_prefill(cfg, params, prompts[first])
    finally:
        transformer.flash_attention = model_fa
    del params, prompts
    kernel = {}
    for label, (q, k, v) in (("local", captured[0]), ("global", captured[cfg.period - 1])):
        Bq, H, S, Dh = q.shape
        H_kv = k.shape[1]
        require(flash_route(q, k, v) == "hopper", (label, "view not routed to Hopper"))
        want = flash_attention_plain(q, k, v, causal=True)
        before, hopper_before = fa.launches, fa.hopper_launches
        got = fa(q, k, v, causal=True)
        require((fa.launches - before, fa.hopper_launches - hopper_before) == (1, 1),
                (label, "launch counts"))
        u, err = bf16_ulps(got, want), max_abs(got, want)
        del got, want
        require(u <= BF16_ULPS, (label, "flash kernel beyond 2 bf16 ulps", u))
        fk = lambda: fa(q, k, v, causal=True)  # noqa: E731
        fl = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                    enable_gqa=True)
        b_ms, b_by = flash_bound(Bq, H, H_kv, S, S, Dh, True, q.dtype)
        r = kernel[label] = dict(
            shape=f"B={Bq} H={H} H_kv={H_kv} S={S} Dh={Dh} causal bf16, strides "
                  f"{tuple(q.stride())}",
            max_abs_err=err, bf16_ulps=u, ms=cuda_time_ms(fk, 5), device_ms=queued_time_ms(fk, 5),
            plain_ms=cuda_time_ms(lambda: flash_attention_plain(q, k, v, causal=True), 1),
            library_ms=cuda_time_ms(fl, 5), bound_ms=b_ms, bound_by=b_by)
        log(f"[llama4] (d) {label} layer's q/k/v, {r['shape']}: Hopper kernel vs plain max |diff| "
            f"{err:.3e} ({u:.2f} bf16 ulps); kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}), plain {r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); {card}")
    out["kernel"] = kernel
    del captured, q, k, v
    free_device_memory()

    # (c) f32 at full width, one group, off the kernel path's bf16
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    c32 = dataclasses.replace(cfg, n_layers=cfg.period, param_dtype=torch.float32,
                              act_dtype=torch.float32)
    p32 = init_params(c32, gen, dev)
    T = check_tokens
    tokens = torch.randint(0, cfg.vocab, (1, T), generator=gen, device=dev)
    before, hopper_before = fa.launches, fa.hopper_launches
    with recorded_routes(transformer) as flash_routes:
        flash, _ = forward_prefill(c32, p32, tokens)
    require((fa.launches - before, fa.hopper_launches - hopper_before) == (cfg.period, 0),
            ("f32 flash launches (all, Hopper)", fa.launches - before))
    with recorded_routes(transformer) as xla_routes:
        xla, _ = forward_prefill(dataclasses.replace(c32, attention_impl="xla"), p32, tokens)
    diffs = route_differences(flash_routes, xla_routes)
    c_dropped = [int((~r.keep).sum()) for r in xla_routes]
    del flash_routes, xla_routes
    log(f"[llama4] (c) f32, 1 x {T}, {c32.n_layers} layers: routing flash vs xla path, "
        f"{'equal in every MoE layer' if not diffs else f'differs: {diffs}'} (capacity "
        f"{moe_capacity(c32, T)}, dropped per layer {c_dropped})")
    require(not diffs, ("f32 routing flash vs xla", diffs))
    err_xla = max_abs(flash, xla)
    log(f"[llama4] (c) last-token logits, flash vs xla path, max |diff| {err_xla:.3e} (max "
        f"|logit| {float(xla.abs().max()):.3f}, tolerance {LM_F32_TOL})")
    require(err_xla <= LM_F32_TOL, ("f32 flash vs xla logits", err_xla))
    del flash, xla
    # decode against prefill, no capacity drops in either (decode never drops)
    nodrop = dataclasses.replace(c32, moe=dataclasses.replace(c32.moe, capacity_factor=float(E)))
    P, n = decode_check
    tokens = torch.randint(0, cfg.vocab, (1, P + n), generator=gen, device=dev)
    _, cache = forward_prefill(nodrop, p32, tokens[:, :P], max_seq=P + n)
    errs = []
    for i in range(n):
        dec, cache = forward_decode(nodrop, p32, tokens[:, P + i], cache, P + i)
        pre, _ = forward_prefill(nodrop, p32, tokens[:, :P + i + 1])
        errs.append(max_abs(dec, pre))
    log(f"[llama4] (c) f32 decode t = {P} .. {P + n - 1} (chunk {cfg.local_chunk}) vs "
        f"forward_prefill of the tokens so far, capacity factor {float(E)}, max |diff| per step "
        + " ".join(f"{e:.3e}" for e in errs) + f" (tolerance {LM_F32_TOL})")
    require(max(errs) <= LM_F32_TOL, ("f32 decode vs prefill logits", errs))
    out.update(f32_flash_vs_xla=err_xla, f32_decode_vs_prefill=max(errs),
               f32_routes_equal=not diffs, f32_dropped_per_layer=c_dropped)
    del p32, cache, dec, pre
    free_device_memory()

    # (e) the training CLI on the reduced config
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama4-scout-17b-a16e",
             "--steps", str(cli_steps), "--ckpt", ckpt, *TRAIN_CLI_ARGS],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, ("llama4 training CLI", res.returncode, res.stderr[-2000:]))
    line = res.stdout.strip().splitlines()[-1]
    require(line.startswith(f"[llama4-scout-17b-a16e] steps={cli_steps} loss "),
            ("CLI output", line))
    out["cli_s"] = time.perf_counter() - t0
    log(f"[llama4] (e) python -m repro_torch.launch.train --arch llama4-scout-17b-a16e --steps "
        f"{cli_steps}: exit 0 in {out['cli_s']:.1f} s; {line}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[llama4] phase body {out['phase_s']:.1f} s; {nvidia_smi_line()}")
    return launches, out


def padded_bags(gen, rows, B, L, dev):
    """int32 [B, L] indices into ``rows`` rows; for L > 1, each bag has a
    seeded length in 1..L and -1 padding after it."""
    idx = torch.randint(0, rows, (B, L), generator=gen, device=dev, dtype=torch.int32)
    if L > 1:
        lens = torch.randint(1, L + 1, (B, 1), generator=gen, device=dev)
        idx = torch.where(torch.arange(L, device=dev)[None, :] < lens, idx, -1)
    return idx.contiguous()


def csr_of(idx):
    """The padded bags as (flat int64 indices, int64 offsets of each bag)."""
    valid = idx >= 0
    offsets = torch.zeros(idx.shape[0], dtype=torch.int64, device=idx.device)
    offsets[1:] = torch.cumsum(valid.sum(1), 0)[:-1]
    return idx[valid].long(), offsets


def bag_library_calls(t, idx):
    """The PyTorch calls that compute the sums of int32 bags ``idx`` on table
    ``t``, by name: ``library``, ``F.embedding_bag`` on the CSR form
    (``sum``); for bags of one also ``gather``, ``table[ids]`` on int64
    ids, and ``index_select`` on the int32 ids (no cast inside the call)."""
    import torch.nn.functional as F

    flat, offsets = csr_of(idx)
    fns = {"library": lambda: F.embedding_bag(flat, t, offsets, mode="sum")}
    if idx.shape[1] == 1:
        ids32, ids64 = idx.reshape(-1), idx.reshape(-1).long()
        fns["gather"] = lambda: t[ids64]
        fns["index_select"] = lambda: torch.index_select(t, 0, ids32)
    return fns


def time_calls(fns, reps):
    """``{name}_ms`` (CUDA events, back to back) and ``{name}_device_ms``
    (queued behind a spin kernel) of each call in ``fns``."""
    r = {}
    for name, fn in fns.items():
        r[f"{name}_ms"] = cuda_time_ms(fn, reps)
        r[f"{name}_device_ms"] = queued_time_ms(fn, reps)
    return r


def bag_bounds_ms(t, idx):
    """Least times (ms) of one bag call on table ``t`` with int32 bags
    ``idx``, over HBM_BYTES_PER_S: by bytes (each distinct gathered row
    once, the indices and the output once) and by sectors (every gathered
    row's 32-byte sectors, then the indices and the output)."""
    row = t.shape[1] * t.element_size()
    flat = idx[idx >= 0].long()
    io = idx.numel() * 4 + idx.shape[0] * row
    start = flat * row
    sectors = int(((start + row - 1) // 32 - start // 32 + 1).sum())
    return ((torch.unique(flat).numel() * row + io) / HBM_BYTES_PER_S * 1e3,
            (sectors * 32 + io) / HBM_BYTES_PER_S * 1e3)


def time_embedding_bag(eb, t, idx, dt, reps):
    """Times of the kernel, its plain version and the library calls of
    ``bag_library_calls`` (``F.embedding_bag``; for bags of one also
    ``table[ids]`` and ``index_select``) on one table and batch, with the
    byte and sector bounds of the rows these bags gather."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain

    (B, L), (rows, dim) = idx.shape, t.shape
    entries = int((idx >= 0).sum())
    fk = lambda: eb(t, idx)  # noqa: E731
    fp = lambda: embedding_bag_plain(t, idx)  # noqa: E731
    lib = bag_library_calls(t, idx)
    lib_err = max_abs(fk(), lib["library"]())
    tb, sector_ms = bag_bounds_ms(t, idx)
    tb, to = tb / 1e3, entries * dim / F32_FLOPS_PER_S
    r = dict(
        ms=cuda_time_ms(fk, reps), device_ms=queued_time_ms(fk, reps),
        profiler_device_ms=device_ms_of(profile_calls(fk, 5), "embedding_bag_kernel"),
        plain_ms=cuda_time_ms(fp, max(reps // 5, 2)), **time_calls(lib, reps),
        bound_ms=max(tb, to) * 1e3, bound_by="bytes" if tb >= to else "operations",
        sector_bound_ms=sector_ms, library_max_abs_diff=lib_err, entries=entries,
        shape=f"V={rows} D={dim} {dt} B={B} L={L} sum, {entries} entries")
    log(f"[embag] {r['shape']}: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms; "
        f"profiler {r['profiler_device_ms']}), plain {r['plain_ms']:.3f} ms, "
        f"F.embedding_bag {r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})"
        + (f", table[ids] {r['gather_ms']:.4f} ms (device {r['gather_device_ms']:.4f}), "
           f"index_select {r['index_select_ms']:.4f} ms (device "
           f"{r['index_select_device_ms']:.4f})" if L == 1 else "")
        + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}), sector bound {sector_ms:.4f} "
        f"ms; kernel vs library max |diff| {lib_err:.3e}")
    return r


def phase_embedding_bag(dev, eb, rows=EMB_ROWS, dim=EMB_DIM, batches=EMB_BATCHES,
                        lengths=EMB_LENGTHS, narrow_dims=EMB_NARROW_DIMS,
                        lookup_ids=EMB_LOOKUP_IDS, reps=20):
    """Phase 6: the embedding-bag path, its checks and times."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    table = torch.randn(rows, dim, generator=gen, device=dev)
    cases = [(B, L) for B in batches for L in lengths]
    bags = {c: padded_bags(gen, rows, *c, dev) for c in cases}
    ids = padded_bags(gen, rows, lookup_ids, 1, dev)
    narrow = {D: torch.randn(rows, D, generator=gen, device=dev, dtype=torch.bfloat16)
              for D in narrow_dims}
    torch.cuda.synchronize()
    log(f"[embag] table {rows:,} x {dim} f32 ({table.numel() * 4 / 1e9:.2f} GB), bags "
        + ", ".join(f"B={B} L={L}" for B, L in cases) + f"; narrow bf16 tables {rows:,} x "
        + "/".join(map(str, narrow_dims)) + f" with {lookup_ids:,} ids as bags of one; set-up "
        f"{time.perf_counter() - t0:.2f} s")
    outs = {}
    eb.launches = 0  # the embedding-bag path's run starts here
    tables = {"f32": table}
    for dt in ("f32", "bf16"):
        if dt == "bf16":
            tables["bf16"] = table.to(torch.bfloat16)
        for c in cases:
            for mode in ("sum", "mean"):
                out = eb(tables[dt], bags[c], mode=mode)
                require(out.shape == (c[0], dim) and out.dtype == tables[dt].dtype, (dt, c, mode))
                outs[(dt, c, mode)] = out
    narrow_outs = {D: eb(t, ids) for D, t in narrow.items()}
    torch.cuda.synchronize()
    launches = {"embedding_bag": eb.launches}
    require(eb.launches == len(outs) + len(narrow_outs), launches)

    worst = {"f32": 0.0, "bf16_abs": 0.0, "bf16_ulps": 0.0}

    def compare(got, t, idx, mode, label):
        want = embedding_bag_plain(t, idx, mode=mode)
        err = max_abs(got, want)
        if t.dtype == torch.float32:
            worst["f32"] = max(worst["f32"], err)
            require(torch.allclose(got, want, rtol=BAG_F32_TOL, atol=BAG_F32_TOL),
                    (label, "embedding bag != plain version", err))
            return f"max |diff| {err:.3e}"
        u = bf16_ulps(got, want)
        worst["bf16_abs"], worst["bf16_ulps"] = max(worst["bf16_abs"], err), \
            max(worst["bf16_ulps"], u)
        require(u <= BF16_ULPS, (label, "embedding bag beyond 2 bf16 ulps", u))
        return f"max |diff| {err:.3e}, {u:.2f} bf16 ulps"

    for (dt, c, mode), out in outs.items():
        log(f"[embag] {dt} B={c[0]} L={c[1]} {mode}: "
            + compare(out, tables[dt], bags[c], mode, (dt, c, mode)))
    for D, out in narrow_outs.items():
        t = narrow[D]
        msg = compare(out, t, ids, "sum", ("bf16", D, "bags of one"))
        require(torch.equal(out.view(torch.int16), t[ids[:, 0].long()].view(torch.int16)),
                (D, "bags of one are not table[ids] bit for bit"))
        log(f"[embag] bf16 D={D} {lookup_ids:,} bags of one: {msg}; equal to table[ids] bit "
            "for bit")
    del narrow_outs
    # edge bags: all padding, one index, a repeated index, the last rows
    # (offsets past 2^31 elements), and no columns of indices at all
    last = rows - 1
    edge = torch.tensor([[-1, -1, -1], [5, -1, -1], [7, 7, 7], [last, last - 1, -1],
                         [-1, 3, -1], [0, last, 0]], dtype=torch.int32, device=dev)
    for dt, t in tables.items():
        for mode in ("sum", "mean"):
            for idx in (edge, edge[:, :0].contiguous()):
                got = eb(t, idx, mode=mode)
                msg = compare(got, t, idx, mode, (dt, "edge", mode))
                require(not got[0].any(), "an all-padding bag is not zero")
                log(f"[embag] {dt} edge bags {tuple(idx.shape)} {mode}: {msg}")
    require(torch.equal(eb(tables["f32"], edge[1:2, :1].contiguous()), tables["f32"][5:6]),
            "a bag of one index is not that row")

    records = {(dt, c): time_embedding_bag(eb, t, bags[c], dt, reps)
               for dt, t in tables.items() for c in cases}
    records.update({("bf16", D): time_embedding_bag(eb, t, ids, "bf16", reps)
                    for D, t in narrow.items()})
    del tables, table, outs, narrow, ids
    free_device_memory()
    main = records[("f32", (batches[0], lengths[-1]))]
    record = dict(
        name="embedding_bag", route="cuda", source="src/repro_torch/csrc/model_kernels.cu",
        replaces="src/repro/kernels/embedding_bag.py:41", launches=None,
        max_abs_err=max(worst["f32"], worst["bf16_abs"]), max_f32_err=worst["f32"],
        max_bf16_ulps=worst["bf16_ulps"], kernel_ms=main["ms"],
        library="torch.nn.functional.embedding_bag(flat, table, offsets, mode='sum')",
        **{k: main[k] for k in ("ms", "device_ms", "profiler_device_ms", "plain_ms",
                                "library_ms", "library_device_ms", "bound_ms", "bound_by",
                                "sector_bound_ms", "shape")},
        others=[{k: v for k, v in r.items() if k not in ("profiler_device_ms", "bound_by")}
                for r in records.values() if r is not main])
    return launches, record


# ---------------------------------------------------------------------------
# Phase 7: the paper's baselines on phase 2's collection, Sada's encodings
# ---------------------------------------------------------------------------

BASELINE_K = 10          # wt_topk's k (the top-k path's)
BASELINE_EDGE_DF = 4     # the edge batch's truncating max_df
BASELINE_MAX_OCC = 8192  # doc_listing.py's cap on Brute-D's window


class HostLocate:
    """``rt::csa_locate_one`` then ``rt::csa_doc_of`` for one SA position,
    replayed on the host with each dependent read a round of a ``Chain``:
    per step the binary search over the sampled positions and the sampled
    test, per LF step one round per wavelet level (word and prefix) and one
    for the symbol's offsets; then the search again, the sample, and the
    search over the document starts."""

    def __init__(self, csa):
        wm = csa.wm
        self.words = wm.words.cpu().numpy().view(np.uint32)
        self.prefix = wm.ones_prefix.cpu().numpy()
        self.zcount = wm.zcount.cpu().numpy()
        self.counts = csa.counts.cpu().numpy()
        self.sym_starts = wm.sym_starts.cpu().numpy()
        self.sampled = csa.sampled.pos.cpu().numpy()
        self.samples = csa.samples.cpu().numpy()
        self.doc_starts = csa.doc_bv.pos.cpu().numpy()
        self.m, self.levels, self.rate = csa.sampled.m, wm.levels, csa.sample_rate

    def lf(self, chain, j):
        """``rt::csa_lf``: one round per wavelet level, one for the
        symbol's offsets."""
        pos, sym = j, 0
        for lvl in range(self.levels):
            w = pos >> 5
            chain.read(("words", lvl, w >> 5), ("prefix", lvl, w >> 5))
            word = int(self.words[lvl, w])
            bit = (word >> (pos & 31)) & 1
            r1 = int(self.prefix[lvl, w]) + bin(word & ((1 << (pos & 31)) - 1)).count("1")
            pos = int(self.zcount[lvl]) + r1 if bit else pos - r1
            sym = (sym << 1) | bit
        chain.read(("counts", sym >> 5), ("sym_starts", sym >> 5))
        return int(self.counts[sym]) + pos - int(self.sym_starts[sym])

    def __call__(self, chain, i):
        j, steps = int(i), 0
        for _ in range(self.rate):
            k = min(chain.search("sampled", self.sampled, j), max(self.m - 1, 0))
            chain.read(("sampled", k >> 5))
            if self.m > 0 and self.sampled[k] == j:
                break
            j = self.lf(chain, j)
            steps += 1
        r = min(max(chain.search("sampled", self.sampled, j), 0), self.m - 1)
        chain.read(("samples", r >> 5))
        return chain.search("doc_starts", self.doc_starts, int(self.samples[r]) + steps + 1) - 1

    def group(self, chain, i):
        """``rt::DaLocate::group``: the same walk by a half-warp, each
        search a 16-way group search whose last rounds also read the entry
        it returns (no read for the sampled test), the step that finds j
        sampled giving the sample's rank."""
        j, steps, r = int(i), 0, None
        for _ in range(self.rate):
            k, at = chain.group_search("sampled", self.sampled, j)
            if k < self.m and at == j:
                r = k
                break
            j = self.lf(chain, j)
            steps += 1
        if r is None:
            r = chain.group_search("sampled", self.sampled, j)[0]
        r = min(max(r, 0), self.m - 1)
        chain.read(("samples", r >> 5))
        return chain.group_search("doc_starts", self.doc_starts,
                                  int(self.samples[r]) + steps + 1)[0] - 1


def host_stored_da(da):
    """DA[i] from the stored array, one read on the chain."""
    def get(chain, i):
        chain.read(("da", int(i) >> 5))
        return int(da[i])
    return get


def host_rmq(chain, table, values, a, b, name):
    """``rt::rmq_leftmost`` over [a, b] on the host: the table's two
    entries, then their values, one round each."""
    levels = table.shape[0]
    k = min(max(int(np.floor(np.log2(max(b - a + 1, 1)))), 0), levels - 1)
    right = max(b - (1 << k) + 1, a)
    chain.read((name, k, a >> 5), (name, k, right >> 5))
    ia, ib = int(table[k, a]), int(table[k, right])
    chain.read((name + ".values", ia >> 5), (name + ".values", ib >> 5))
    return ib if (values[ib] < values[ia] or (values[ib] == values[ia] and ib < ia)) else ia


def host_sada_c(values, table, get_doc, lo, hi, d, max_df):
    """The Sada-C recursion per query in Python (the reference's
    trajectory), with the kernel thread's dependent reads on one ``Chain``
    per query (``get_doc(chain, k)``: a stored DA or the locate): (docs
    rows, counts, pops, chains)."""
    n = table.shape[1]
    cap, max_pops = max_df + 4, 2 * max_df + 8
    rows, cnts, pops_q, chains = [], [], [], []
    for a0, b0 in zip(lo.tolist(), hi.tolist()):
        stack, seen, out, pops, chain = [(a0, b0 - 1)], set(), [], 0, Chain()
        chain.read(("lo", 0), ("hi", 0))
        while stack and len(out) < max_df and pops < max_pops:
            a, b = stack.pop()
            pops += 1
            if a > b or a0 >= b0:
                continue
            r = host_rmq(chain, table, values, min(max(min(a, b0 - 1), 0), n - 1),
                         min(max(min(b, b0 - 1), 0), n - 1), "c")
            g = get_doc(chain, r)
            if g in seen:
                continue
            seen.add(g)
            out.append(g)
            if r + 1 <= b and len(stack) < cap:
                stack.append((r + 1, b))
            if a <= r - 1 and len(stack) < cap:
                stack.append((a, r - 1))
        rows.append(out + [-1] * (max_df - len(out)))
        cnts.append(len(out))
        pops_q.append(pops)
        chains.append(chain)
    return (np.asarray(rows, np.int32).reshape(len(cnts), max_df), np.asarray(cnts, np.int32),
            pops_q, chains)


def join_slowest(chain, parts):
    """Add the slowest of ``parts`` (chains run side by side after
    ``chain``'s reads) to ``chain``'s rounds, and every part's lines and
    reads to its own."""
    if not parts:
        return
    worst = max(parts, key=lambda c: (c.l2, c.l1))
    chain.l2 += worst.l2
    chain.l1 += worst.l1
    for part in parts:
        chain.lines |= part.lines
        chain.reads += part.reads


def host_sada_c_warp(values, table, source, lo, hi, d, max_df):
    """The warp Sada-C kernel per query in Python: the recursion with each
    interval's argmin and document resolved when it is pushed
    (``rt::sada_c_resolve``: on a stored DA, ``source`` an int array, the
    table's two entries, then their values and documents in one round; on
    the CSA, ``source`` a ``HostLocate``, the RMQ, then its ``group``
    locate).  The query's ``Chain``: the root's resolution, and per
    reported pop the slower of its children's resolutions, one per
    half-warp, each its own chain over the lines the query read before; a
    pruned or invalid pop reads only shared memory, and a child the loop
    would never pop is not resolved.  (docs rows, counts, pops, chains)."""
    levels, n = table.shape
    cap, max_pops = max_df + 4, 2 * max_df + 8
    rows, cnts, pops_q, chains = [], [], [], []
    for a0, b0 in zip(lo.tolist(), hi.tolist()):
        chain = Chain()
        chain.read(("lo", 0), ("hi", 0))

        def resolve(ch, a, b):
            x, y = min(max(min(a, b0 - 1), 0), n - 1), min(max(min(b, b0 - 1), 0), n - 1)
            if isinstance(source, HostLocate):
                k = host_rmq(ch, table, values, x, y, "c")
                return k, source.group(ch, k)
            lvl = min(max(max(y - x + 1, 1).bit_length() - 1, 0), levels - 1)
            right = max(y - (1 << lvl) + 1, x)
            ch.read(("c", lvl, x >> 5), ("c", lvl, right >> 5))
            ia, ib = int(table[lvl, x]), int(table[lvl, right])
            ch.read(*((arr, i >> 5) for arr in ("c.values", "da") for i in (ia, ib)))
            k = ib if (values[ib] < values[ia] or (values[ib] == values[ia] and ib < ia)) else ia
            return k, int(source[k])

        stack = [(a0, b0 - 1, *(resolve(chain, a0, b0 - 1) if a0 < b0 else (0, 0)))]
        seen, out, pops = set(), [], 0
        while stack and len(out) < max_df and pops < max_pops:
            a, b, k, g = stack.pop()
            pops += 1
            if a > b or a0 >= b0 or g in seen:
                continue
            seen.add(g)
            out.append(g)
            more = len(out) < max_df and pops < max_pops
            kids = []
            if more and k + 1 <= b and len(stack) < cap:
                kids.append((k + 1, b))
            if more and a <= k - 1 and len(stack) + len(kids) < cap:
                kids.append((a, k - 1))
            halves = [Chain(seen=chain.lines) for _ in kids]
            stack += [(x, y, *resolve(h, x, y)) for (x, y), h in zip(kids, halves)]
            join_slowest(chain, halves)
        rows.append(out + [-1] * (max_df - len(out)))
        cnts.append(len(out))
        pops_q.append(pops)
        chains.append(chain)
    return (np.asarray(rows, np.int32).reshape(len(cnts), max_df), np.asarray(cnts, np.int32),
            pops_q, chains)


def host_ilcp_warp(vilcp, table, run_starts, get_doc, lo, hi, d, max_df):
    """The warp ILCP kernel per query in Python: the Fig-1 recursion with
    each run's DA positions taken 32 at a time, as the warp takes them.
    The query's ``Chain``: the root's run searches and RMQ, per valid pop
    its run's bounds, per chunk the slowest lane's reads (each lane its own
    chain over the lines the query read before; the lanes' lines join the
    query's after the chunk).  (docs rows, counts, pops, chunks, chains)."""
    rho = table.shape[1]
    cap, max_pops = max_df + 4, 2 * max_df + 8
    starts = run_starts[:rho]
    rows, cnts, pops_q, chunks_q, chains = [], [], [], [], []
    for a0, b0 in zip(lo.tolist(), hi.tolist()):
        chain = Chain()
        chain.read(("lo", 0), ("hi", 0))
        lr = chain.search("run_starts", starts, a0, right=True) - 1
        hr = chain.search("run_starts", starts, b0 - 1, right=True) - 1
        if a0 < b0 and lr <= hr:
            host_rmq(chain, table, vilcp, min(max(lr, 0), rho - 1), min(max(hr, 0), rho - 1),
                     "table")
        stack, seen, out, pops, chunks = [(lr, hr)], set(), [], 0, 0
        while stack and len(out) < max_df and pops < max_pops:
            a, b = stack.pop()
            pops += 1
            if a > b or a0 >= b0:
                continue
            a_, b_ = min(max(a, 0), rho - 1), min(max(b, 0), rho - 1)
            r = host_rmq(Chain(), table, vilcp, a_, b_, "table")  # resolved at push time
            chain.read(("run_starts", r >> 5), ("run_starts", (r + 1) >> 5))
            k, j = max(a0, int(run_starts[r])), min(b0, int(run_starts[r + 1]))
            stopped = False
            while k < j and len(out) < max_df and not stopped:
                nvalid = min(j - k, 32)
                lanes = [Chain(seen=chain.lines) for _ in range(nvalid)]
                g = [get_doc(lane, k + i) for i, lane in enumerate(lanes)]
                join_slowest(chain, lanes)
                chunks += 1
                first = nvalid
                for i, x in enumerate(g):
                    if x in seen or x in g[:i]:
                        first = i
                        break
                room = max_df - len(out)
                emit = min(first, nvalid, room)
                for x in g[:emit]:
                    seen.add(x)
                    out.append(x)
                stopped = first < nvalid and first < room
                k += emit
            if stopped:
                continue
            if r + 1 <= b and len(stack) < cap:
                stack.append((r + 1, b))
            if a <= r - 1 and len(stack) < cap:
                stack.append((a, r - 1))
        rows.append(out + [-1] * (max_df - len(out)))
        cnts.append(len(out))
        pops_q.append(pops)
        chunks_q.append(chunks)
        chains.append(chain)
    return (np.asarray(rows, np.int32).reshape(len(cnts), max_df), np.asarray(cnts, np.int32),
            pops_q, chunks_q, chains)


def host_wt(words, prefix, zcount, lo, hi, max_df):
    """The WT DFS per query in Python, each internal node one round of the
    query's ``Chain`` (both ends' word and prefix): (docs, freqs, counts,
    pops, chains)."""
    words = words.view(np.uint32)
    levels = words.shape[0]

    def rank1(lvl, pos):
        w = pos >> 5
        return int(prefix[lvl, w]) + bin(int(words[lvl, w]) & ((1 << (pos & 31)) - 1)).count("1")

    docs, freqs, cnts, pops_q, chains = [], [], [], [], []
    for a0, b0 in zip(lo.tolist(), hi.tolist()):
        stack, out, tf, pops, chain = [(0, a0, b0, 0)], [], [], 0, Chain()
        chain.read(("lo", 0), ("hi", 0))
        while stack and len(out) < max_df:
            lvl, a, b, val = stack.pop()
            pops += 1
            if a >= b:
                continue
            if lvl >= levels:
                out.append(val)
                tf.append(b - a)
                continue
            chain.read(*((arr, lvl, pos >> 10) for arr in ("words", "prefix") for pos in (a, b)),
                       ("zcount", 0))
            r1a, r1b, z = rank1(lvl, a), rank1(lvl, b), int(zcount[lvl])
            if r1a < r1b:
                stack.append((lvl + 1, z + r1a, z + r1b, (val << 1) | 1))
            if a - r1a < b - r1b:
                stack.append((lvl + 1, a - r1a, b - r1b, val << 1))
        docs.append(out + [-1] * (max_df - len(out)))
        freqs.append(tf + [0] * (max_df - len(tf)))
        cnts.append(len(out))
        pops_q.append(pops)
        chains.append(chain)
    return (np.asarray(docs, np.int32).reshape(len(cnts), max_df),
            np.asarray(freqs, np.int32).reshape(len(cnts), max_df), np.asarray(cnts, np.int32),
            pops_q, chains)


def check_rows(docs, cnt, lo, hi, da, max_df, what, freqs=None, ascending=True):
    """Each row against the host oracle: distinct DA[lo:hi] (ascending and
    exact where sorted; a distinct subset otherwise, all of it when df fits),
    with their frequencies where given."""
    for r in range(len(cnt)):
        vals, tf = np.unique(da[lo[r]:hi[r]], return_counts=True)
        c = int(cnt[r])
        require(c == min(len(vals), max_df), (what, r, "count", c, len(vals)))
        require(np.all(docs[r, c:] == -1), (what, r, "padding"))
        row = docs[r, :c]
        if ascending:
            require(np.array_equal(row, vals[:c]), (what, r, "rows"))
        else:
            require(len(set(row.tolist())) == c and set(row.tolist()) <= set(vals.tolist()),
                    (what, r, "rows"))
            if len(vals) <= max_df:
                require(set(row.tolist()) == set(vals.tolist()), (what, r, "incomplete"))
        if freqs is not None:
            require(np.array_equal(freqs[r, :c], tf[:c]) and np.all(freqs[r, c:] == 0),
                    (what, r, "freqs"))


def sada_variant_checks(label, data, ranges, lens, da, ilcp):
    """All five Sada encodings built on the card for one index: on the
    same ranges each df equals the sparse variant's, the ILCP count and the
    oracle; bits per char and count time per batch."""
    from repro_torch.core.ilcp import ilcp_count_docs_batch
    from repro_torch.core.sada import VARIANTS, build_sada, sada_count_batch

    truth = np.concatenate([
        np.asarray([len(np.unique(da[a:b])) for a, b in zip(lo.cpu().numpy(), hi.cpu().numpy())])
        for lo, hi in ranges])
    ilcp_df = torch.cat([ilcp_count_docs_batch(ilcp, lo, hi, m)
                         for (lo, hi), m in zip(ranges, lens)]).cpu().numpy()
    require(np.array_equal(ilcp_df, truth), (label, "ILCP count != oracle"))
    out, dfs = {}, {}
    for v in VARIANTS:
        t = time.perf_counter()
        s = build_sada(data, v)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        dfs[v] = torch.cat([sada_count_batch(s, lo, hi) for lo, hi in ranges]).cpu().numpy()
        lo, hi = ranges[0]
        out[v] = {"bits_per_char": s.modeled_bits() / data.n, "build_s": build_s,
                  "count_ms_per_batch": cuda_time_ms(lambda s=s: sada_count_batch(s, lo, hi), 20),
                  "batch": int(lo.shape[0])}
        require(np.array_equal(dfs[v], truth), (label, v, "df != oracle"))
        del s
    require(all(np.array_equal(dfs[v], dfs["sparse"]) for v in VARIANTS))
    log(f"[baselines] Sada encodings at n={data.n} ({label}, {len(truth)} ranges, df == sparse "
        "== ILCP count == oracle): " + "; ".join(
            f"{v} {o['bits_per_char']:.4f} bpc, build {o['build_s']:.3f} s, count "
            f"{o['count_ms_per_batch']:.4f} ms/batch of {o['batch']}" for v, o in out.items()))
    return out


def phase_baselines(svc, data, full_batches, large, lat, kernels):
    """Phase 7: Brute-D, Sada-C-D, Sada-C-L, Sada-I-D, Sada-I-L, WT and
    ``wt_topk`` on phase 2's index and patterns, against the host oracle
    and the kernels' plain versions; Sada's five encodings on the indexes
    of phases 2 and 3."""
    from repro_torch.core.csa import csa_search_planned
    from repro_torch.core.ilcp import ilcp_list_docs_csa_batch, ilcp_list_docs_da_planned
    from repro_torch.core.listing import (
        brute_list_da_batch, sada_c_list_docs_csa_batch, sada_c_list_docs_da_batch,
    )
    from repro_torch.core.wtlist import (
        build_da_wavelet, wt_list_docs_batch, wt_modeled_bits, wt_topk_batch,
    )
    from repro_torch.data.collections import pad_patterns
    from repro_torch.kernels.ilcp_list import ilcp_list_plain, runs_of
    from repro_torch.kernels.sada_c_list import sada_c_list_plain
    from repro_torch.kernels.wt_list import wt_list_plain
    from repro_torch.succinct.rmq import (
        rmq_build, rmq_modeled_bits_succinct, rmq_modeled_bits_table,
    )

    sc, il, wt = kernels
    dev = svc.da.device
    csa, ilcp, da_t = svc.csa, svc.ilcp, svc.da
    n, d = csa.n, csa.d
    t = time.perf_counter()
    rmq_c = rmq_build(data.c)
    wm = build_da_wavelet(da_t, d)
    torch.cuda.synchronize()
    log(f"[baselines] C's RMQ ({rmq_c.levels} x {n}) and the DA wavelet ({wm.levels} levels) "
        f"built on the card in {time.perf_counter() - t:.3f} s")
    ranges, lens = [], []
    for batch in full_batches:
        p, ln = pad_patterns(batch, 8)
        p, ln = torch.from_numpy(p).to(dev), torch.from_numpy(ln).to(dev)
        lo, hi = csa_search_planned(csa, p, ln)
        ranges.append((lo, hi))
        lens.append(ln)
    max_df = d + 1
    occ = max(int((hi - lo).max()) for lo, hi in ranges)
    max_occ = min(occ, BASELINE_MAX_OCC)
    listers = {
        "Brute-D": lambda lo, hi, md: brute_list_da_batch(da_t, lo, hi, max_occ, md),
        "Sada-C-D": lambda lo, hi, md: sada_c_list_docs_da_batch(rmq_c, da_t, lo, hi, d, md),
        "Sada-C-L": lambda lo, hi, md: sada_c_list_docs_csa_batch(rmq_c, csa, lo, hi, md),
        "Sada-I-D": lambda lo, hi, md: ilcp_list_docs_da_planned(ilcp, da_t, lo, hi, md),
        "Sada-I-L": lambda lo, hi, md: ilcp_list_docs_csa_batch(ilcp, csa, lo, hi, md),
        "WT": lambda lo, hi, md: wt_list_docs_batch(wm, lo, hi, md),
        "wt_topk": lambda lo, hi, md: wt_topk_batch(wm, lo, hi, BASELINE_K, md),
    }
    counters = {"sada_c_list": (sc, "launches"), "sada_c_list[csa]": (sc, "csa_launches"),
                "ilcp_list": (il, "launches"), "ilcp_list[csa]": (il, "csa_launches"),
                "wt_list": (wt, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)  # the main path's run starts here
    outs = {name: [] for name in listers}
    secs = {name: [] for name in listers}
    for lo, hi in ranges:
        for name, fn in listers.items():
            t = time.perf_counter()
            out = [x.cpu().numpy() for x in fn(lo, hi, max_df)]
            secs[name].append(time.perf_counter() - t)
            outs[name].append(out)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    B = len(ranges)
    require(launches == {"sada_c_list": B, "sada_c_list[csa]": B, "ilcp_list": B,
                         "ilcp_list[csa]": B, "wt_list": 2 * B}, launches)
    log(f"[baselines] {sum(len(b) for b in full_batches)} patterns in {B} batches, max_df "
        f"{max_df}, Brute-D window {max_occ} (largest occ {occ}); launches {launches}")
    log("[baselines] host s per batch (first call, result on the host): " + "; ".join(
        f"{k} " + " ".join(f"{x:.4f}" for x in v) for k, v in secs.items()))

    # every row against the host oracle
    da = da_t.cpu().numpy()
    for b, (lo, hi) in enumerate(ranges):
        lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
        docs, cnt, freqs = outs["Brute-D"][b]  # its window truncates at max_occ
        check_rows(docs, cnt, lo, np.minimum(hi, lo + max_occ), da, max_df, "Brute-D", freqs)
        for name in ("Sada-C-D", "Sada-C-L", "Sada-I-D", "Sada-I-L"):
            check_rows(*outs[name][b], lo, hi, da, max_df, name, ascending=False)
        docs, freqs, cnt = outs["WT"][b]
        check_rows(docs, cnt, lo, hi, da, max_df, "WT", freqs)
        for name, twin in (("Sada-C-L", "Sada-C-D"), ("Sada-I-L", "Sada-I-D")):
            # one discovery order per recursion, whatever the DA source
            require(all(np.array_equal(x, y) for x, y in zip(outs[name][b], outs[twin][b])),
                    (name, "rows differ from", twin))
        tdocs, ttf = outs["wt_topk"][b]
        for r in range(len(lo)):
            want_d, want_tf, _ = host_topk(da, lo[r], hi[r], BASELINE_K)
            k = len(want_d)
            require(np.array_equal(tdocs[r, :k], want_d) and np.array_equal(ttf[r, :k], want_tf)
                    and np.all(tdocs[r, k:] == -1), ("wt_topk", b, r))
    # the edge batch: a truncating max_df
    lo, hi = ranges[0]
    hlo, hhi = lo.cpu().numpy(), hi.cpu().numpy()
    for name, fn in listers.items():
        if name == "wt_topk":
            continue
        out = [x.cpu().numpy() for x in fn(lo, hi, BASELINE_EDGE_DF)]
        if name == "WT":
            check_rows(out[0], out[2], hlo, hhi, da, BASELINE_EDGE_DF, name, out[1])
        elif name == "Brute-D":
            check_rows(out[0], out[1], hlo, np.minimum(hhi, hlo + max_occ), da,
                       BASELINE_EDGE_DF, name, out[2])
        else:
            check_rows(out[0], out[1], hlo, hhi, da, BASELINE_EDGE_DF, name, ascending=False)
        require(np.any(out[-1 if name == "WT" else 1] == BASELINE_EDGE_DF), (name, "no truncation"))
    log(f"[baselines] every row of the {B} batches and the max_df={BASELINE_EDGE_DF} edge batch "
        "matches the host oracle")

    # each kernel against its plain version on the card, bit for bit, on
    # batch 0 with its last four rows masked (0, 0) twice, (0, n) and
    # (n - 1, n): one batch of the main path's shape, whose plain run (a
    # lockstep loop as long as its longest row) is timed too
    lo = torch.cat([lo[:-4], torch.tensor([0, 0, 0, n - 1], dtype=torch.int32, device=dev)])
    hi = torch.cat([hi[:-4], torch.tensor([0, n, 0, n], dtype=torch.int32, device=dev)])
    hlo, hhi = lo.cpu().numpy(), hi.cpu().numpy()
    table, values = rmq_c.table, rmq_c.values
    il_args = (ilcp.vilcp, ilcp.rmq.table, ilcp.run_starts)
    cases = {
        "sada_c_list": (lambda lo, hi: sc(values, table, da_t, lo, hi, d=d, max_df=max_df),
                        lambda lo, hi: sada_c_list_plain(values, table, da_t, lo, hi, d=d,
                                                         max_df=max_df)),
        "sada_c_list[csa]": (lambda lo, hi: sc(values, table, csa, lo, hi, d=d, max_df=max_df),
                             lambda lo, hi: sada_c_list_plain(values, table, csa, lo, hi, d=d,
                                                              max_df=max_df)),
        "ilcp_list[csa]": (lambda lo, hi: il(*il_args, csa, lo, hi, d=d, max_df=max_df),
                           lambda lo, hi: ilcp_list_plain(
                               *il_args, csa, lo, hi, runs_of(ilcp.run_starts, lo),
                               runs_of(ilcp.run_starts, hi - 1), d=d, max_df=max_df)),
        "wt_list": (lambda lo, hi: wt(wm.words, wm.ones_prefix, wm.zcount, lo, hi,
                                      max_df=max_df),
                    lambda lo, hi: wt_list_plain(wm.words, wm.ones_prefix, wm.zcount, lo, hi,
                                                 max_df=max_df)),
    }
    plain_ms, kout = {}, {}
    for name, (kern, plain) in cases.items():
        k = [x.cpu() for x in kern(lo, hi)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        p = plain(lo, hi)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t) * 1e3
        kout[name] = [x.numpy() for x in k]
        mm = sum(int((x != y.cpu()).sum()) for x, y in zip(k, p))
        log(f"[baselines] {name} on batch 0 with masked rows and (0, n): mismatches against "
            f"the plain version {mm}; counts {kout[name][-1].tolist()}")
        require(mm == 0, (name, "kernel != plain version"))

    # times and bounds at the main path's shape (batch 0), from this run's
    # work: bytes of every read the replay makes plus the outputs; latency,
    # the slowest query's chain at the probe's L1 / L2 latencies (beside it
    # every round at the L2 latency)
    records = []
    vals_h, table_h = values.cpu().numpy(), table.cpu().numpy()
    locate = HostLocate(csa)
    B0 = len(hlo)

    def all_l2_ms(chains):
        return max(c.l1 + c.l2 for c in chains) * lat["l2_ns"] * 1e-6

    def record(name, replaces, kfn, chains, out_words, shape, byte_chains=None):
        """``byte_chains``: the replay whose reads give the byte bound
        (default ``chains``, the latency bound's)."""
        ms = cuda_time_ms(kfn, 20)
        dev_ms = queued_time_ms(kfn, 20)
        reads = sum(c.reads for c in (byte_chains or chains))
        nbytes = (reads + out_words + 2 * B0) * 4
        ops = 10 * reads
        byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3
        lat_ms, rounds = longest(chains, lat)
        records.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/retrieval_kernels.cu",
            replaces=replaces, launches=None, max_abs_err=0, mismatches=0, ms=ms,
            kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms[name], library_ms=None,
            bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
            latency_chain=rounds, latency_bound_ms=lat_ms, latency_all_l2_ms=all_l2_ms(chains),
            shape=shape))

    def same(name, host):
        require(all(np.array_equal(x, y) for x, y in zip(host, kout[name])),
                (name, "kernel != host replay of the recursion"))

    # Sada-C: the kernel's rows against both replays of the recursion; the
    # latency bound is the warp design's chain, the one-thread design's
    # (the earlier kernel's) beside it, and the byte bound the one-thread
    # replay's reads, as before
    from repro_torch.kernels.sada_c_list import shared_bytes_per_warp

    log(f"[baselines] sada_c_list: one warp (query) a block, "
        f"shared memory a warp {shared_bytes_per_warp(d, max_df)} B")
    for name, get_one, source, extra in (
            ("sada_c_list", host_stored_da(da), da, ""),
            ("sada_c_list[csa]", locate, locate, f" sample_rate={csa.sample_rate}")):
        hd, hc, pops, one_chains = host_sada_c(vals_h, table_h, get_one, hlo, hhi, d, max_df)
        same(name, (hd, hc))
        wd, wc, wpops, chains = host_sada_c_warp(vals_h, table_h, source, hlo, hhi, d, max_df)
        require(wpops == pops, (name, "the warp replay's pops differ"))
        same(name, (wd, wc))
        record(name, "src/repro/core/listing.py:147 (XLA, sada_c_list_docs"
               + ("_csa" if name.endswith("[csa]") else "") + "; no TPU kernel)",
               lambda name=name: cases[name][0](lo, hi), chains, B0 * (max_df + 1),
               f"B={B0} max_df={max_df} d={d} n={n} pops={sum(pops)} "
               f"reported={int(hc.sum())}{extra}", byte_chains=one_chains)
        one_ms, one_rounds = longest(one_chains, lat)
        records[-1].update(shared_bytes_per_warp=shared_bytes_per_warp(d, max_df),
                           latency_bound_one_thread_ms=one_ms,
                           latency_chain_one_thread=one_rounds,
                           latency_all_l2_one_thread_ms=all_l2_ms(one_chains))
        log(f"[baselines] {name} chains: warp design {records[-1]['latency_chain']} "
            f"({records[-1]['latency_bound_ms']:.5f} ms), one thread a query {one_rounds} "
            f"({one_ms:.5f} ms)")
    hd, hc, pops, chunks, chains = host_ilcp_warp(
        ilcp.vilcp.cpu().numpy(), ilcp.rmq.table.cpu().numpy(), ilcp.run_starts.cpu().numpy(),
        locate, hlo, hhi, d, max_df)
    same("ilcp_list[csa]", (hd, hc))
    record("ilcp_list[csa]", "src/repro/core/ilcp.py:223 (XLA, ilcp_list_docs_csa; the Sada-I-D "
           "instantiation replaces src/repro/kernels/ilcp_list.py:193)",
           lambda: cases["ilcp_list[csa]"][0](lo, hi), chains, B0 * (max_df + 1),
           f"B={B0} max_df={max_df} d={d} rho={ilcp.nruns} pops={sum(pops)} "
           f"chunks={sum(chunks)}")
    wd, wf, wc, pops, chains = host_wt(wm.words.cpu().numpy(), wm.ones_prefix.cpu().numpy(),
                                       wm.zcount.cpu().numpy(), hlo, hhi, max_df)
    same("wt_list", (wd, wf, wc))
    require(all(p <= max(1, c * (wm.levels + 1)) for p, c in zip(pops, wc)), "WT pop bound")
    record("wt_list", "src/repro/core/wtlist.py:27 (XLA, wt_list_docs; no TPU kernel)",
           lambda: cases["wt_list"][0](lo, hi), chains, B0 * (2 * max_df + 1),
           f"B={B0} max_df={max_df} levels={wm.levels} pops={sum(pops)}")
    log("[baselines] kernels: " + "; ".join(
        f"{r['name']} {r['ms']:.5f} ms, device {r['device_ms']:.5f}, bound {r['bound_ms']:.7f} "
        f"({r['bound_by']}), latency bound {r['latency_bound_ms']:.5f} "
        f"({r['latency_chain']}; all at L2 {r['latency_all_l2_ms']:.5f}), "
        f"plain {r['plain_ms']:.2f}" for r in records))

    # each structure's modeled bits per char
    bpc = {
        "DA (Brute-D, Sada-C-D, Sada-I-D)": n * ceil_log2(d) / n,
        "CSA (RLCSA model)": csa.modeled_bits_rlcsa() / n,
        "RMQ over C, succinct (Sada-C)": rmq_modeled_bits_succinct(n) / n,
        "RMQ over C, sparse table as stored": rmq_modeled_bits_table(rmq_c) / n,
        "ILCP listing (Sada-I)": ilcp.modeled_bits_listing() / n,
        "WT over DA": wt_modeled_bits(wm) / n,
    }
    log("[baselines] modeled bits per char: " + "; ".join(f"{k} {v:.4f}" for k, v in bpc.items()))

    # Sada's five encodings on phase 2's and phase 3's indexes
    sada = {"full": sada_variant_checks("phase 2", data, ranges, lens, da, ilcp)}
    del rmq_c, wm
    sada["large"] = sada_variant_checks(
        "phase 3", large["data"], large["ranges"], [ln for _, ln in large["batches"]],
        large["da"].cpu().numpy(), large["ilcp"])
    records[0].update(modeled_bits_per_char=bpc, sada_encodings=sada,
                      host_s_per_batch={k: v for k, v in secs.items()})
    return launches, records


# ---------------------------------------------------------------------------
# Phase 8: the docs-sharded service over the collections of phases 2 and 2b
# ---------------------------------------------------------------------------

SHARDS = 4


def sharded_replay(n_shards):
    """Launches of one replay of each sharded program: the flat program's,
    once per shard."""
    return {kind: {k: n_shards * v for k, v in per.items()}
            for kind, per in REPLAY_LAUNCHES.items()}


def eager_sharded(ssvc, kind, batch, engine="auto", max_df=None, k=None, max_buf=None,
                  conjunctive=False, max_terms=4):
    """What a sharded endpoint computes, run eagerly (the program functions,
    no cache) on the same padded batch with the Brute-L window of the
    service's last call of that bucket, and the window's plan pass where
    the window is automatic (``eager_endpoint``'s counterpart)."""
    from repro_torch.serve import sharded as SH

    bases = ssvc._bases()
    if kind == "tfidf":
        pats, lens = ssvc._pad_terms(batch, max_terms)
        docs, scores = SH._sharded_tfidf_program(ssvc.coll.d, k, conjunctive, max_buf,
                                                 ssvc.shards, bases, pats, lens)
        return docs[:len(batch)].cpu().numpy(), scores[:len(batch)].cpu().numpy()
    pats, lens, B = ssvc._pad_batch(batch)
    knobs = ssvc._knobs(engine)

    def plan_pass():
        lo, hi, eng, occ, df = (x.cpu().numpy() for x in SH._sharded_plan_program(
            ssvc.shards, pats, lens, *knobs))
        return {"lo": lo[:, :B], "hi": hi[:, :B], "engine_shard": eng[:, :B], "occ": occ[:B],
                "df": df[:B]}

    if kind == "plan":
        return plan_pass()
    key = (tuple(pats.shape), max_df, max_buf) if kind == "list" else \
        (tuple(pats.shape), k, max_buf)
    if ssvc.brute_window is None:
        plan_pass()
        win = ssvc._brute_windows[(kind, key)]
    else:
        win = min(ssvc.brute_window, max_buf)
    if kind == "list":
        docs, cnt = SH._sharded_list_program(max_df, win, max_buf, ssvc.shards, bases, pats,
                                             lens, *knobs)
    else:
        docs, cnt = SH._sharded_topk_program(k, ssvc._topk_max_df(max_buf), win, max_buf,
                                             ssvc.shards, bases, pats, lens, *knobs)
    return docs[:B].cpu().numpy(), cnt[:B].cpu().numpy()


def build_sharded(label, flat, dev, topk_index):
    """The flat service's collection as ``SHARDS`` document shards on the
    card (``RetrievalService.build(mesh=...)``), validated."""
    from repro_torch.dist.sharding import make_docs_mesh
    from repro_torch.serve.retrieval import RetrievalService

    t0 = time.perf_counter()
    ssvc = RetrievalService.build(flat.coll, mesh=make_docs_mesh(SHARDS, dev), block_size=64,
                                  beta=16.0, topk_index=topk_index, device=dev)
    log(f"[sharded] {label}: {SHARDS} shards of n = "
        f"{[sh.coll.n for sh in ssvc.shards]}, d = {[sh.coll.d for sh in ssvc.shards]}, built "
        f"in {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ssvc.build_seconds.items()) + "; per shard "
        + "; ".join(", ".join(f"{k} {v:.2f}" for k, v in sh.build_seconds.items())
                    for sh in ssvc.shards) + f"; flat build {sum(flat.build_seconds.values()):.2f} s")
    require(len(ssvc.fingerprints) == SHARDS * len(flat.fingerprints), ssvc.fingerprints)
    return ssvc


def sharded_calls_8a(ssvc, flat, batch, max_df, buf):
    """(sharded graph call, eager call, flat graph call) of each 8a case."""
    calls = {
        "plan": (lambda: ssvc.plan(batch), lambda: eager_sharded(ssvc, "plan", batch),
                 lambda: flat.plan(batch)),
        "count": (lambda: ssvc.count(batch), lambda: eager_sharded(ssvc, "plan", batch)["df"],
                  lambda: flat.count(batch)),
        "count[bogus]": (lambda: ssvc.count(batch, engine="bogus"),
                         lambda: eager_sharded(ssvc, "plan", batch)["df"],
                         lambda: flat.count(batch)),
    }
    for engine in ("auto", "ilcp", "brute", "pdl"):
        calls[f"list_docs[{engine}]"] = (
            lambda e=engine: ssvc.list_docs_arrays(batch, max_df=max_df, engine=e, max_buf=buf),
            lambda e=engine: eager_sharded(ssvc, "list", batch, e, max_df, max_buf=buf),
            lambda e=engine: flat.list_docs_arrays(batch, max_df=max_df, engine=e, max_buf=buf))
    calls["list_docs[auto,pinned]"] = (
        pinned(ssvc, lambda: ssvc.list_docs_arrays(batch, max_df=max_df, max_buf=buf), buf),
        pinned(ssvc, lambda: eager_sharded(ssvc, "list", batch, "auto", max_df, max_buf=buf),
               buf),
        pinned(flat, lambda: flat.list_docs_arrays(batch, max_df=max_df, max_buf=buf), buf))
    return calls


def sharded_calls_8b(ssvc, flat, batch, queries):
    """(sharded graph call, eager call, flat graph call) of each 8b case."""
    calls = {}
    for engine, pin in (("auto", False), ("brute", False), ("pdl", False), ("ilcp", False),
                        ("auto", True)):
        fns = (lambda e=engine: ssvc.topk_arrays(batch, k=TOPK_K, engine=e, max_buf=MAX_BUF),
               lambda e=engine: eager_sharded(ssvc, "topk", batch, e, k=TOPK_K,
                                              max_buf=MAX_BUF),
               lambda e=engine: flat.topk_arrays(batch, k=TOPK_K, engine=e, max_buf=MAX_BUF))
        if pin:
            fns = tuple(pinned(svc, f) for svc, f in zip((ssvc, ssvc, flat), fns))
        calls[f"topk[{engine}{',pinned' if pin else ''}]"] = fns
    for conj in (False, True):
        calls[f"tfidf[{'and' if conj else 'or'}]"] = (
            lambda c=conj: ssvc.tfidf_arrays(queries, k=TOPK_K, conjunctive=c,
                                             max_buf=TFIDF_MAX_BUF),
            lambda c=conj: eager_sharded(ssvc, "tfidf", queries, k=TOPK_K, conjunctive=c,
                                         max_buf=TFIDF_MAX_BUF),
            lambda c=conj: flat.tfidf_arrays(queries, k=TOPK_K, conjunctive=c,
                                             max_buf=TFIDF_MAX_BUF))
    return calls


#: the programs each phase-8 case runs (the count's plan included)
SHARDED_KINDS = {"plan": ("plan",), "count": ("plan",), "count[bogus]": ("plan",),
                 "list_docs[auto,pinned]": ("list",), "topk[auto,pinned]": ("topk",)}


def sharded_kinds(name):
    if name in SHARDED_KINDS:
        return SHARDED_KINDS[name]
    return ("tfidf",) if name.startswith("tfidf") else ("plan", name.split("[")[0][:4])


def sharded_no_sync(ssvc_a, batch_a, max_df, buf, ssvc_b, batch_b, queries):
    """Every sharded program run eagerly under ``set_sync_debug_mode("error")``:
    any host sync inside one raises."""
    from repro_torch.serve import sharded as SH

    pats, lens, _ = ssvc_a._pad_batch(batch_a)
    knobs = ssvc_a._knobs("auto")
    tpats, tlens, _ = ssvc_b._pad_batch(batch_b)
    tknobs = ssvc_b._knobs("auto")
    qpats, qlens = ssvc_b._pad_terms(queries, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        SH._sharded_plan_program(ssvc_a.shards, pats, lens, *knobs)
        SH._sharded_list_program(max_df, buf, buf, ssvc_a.shards, ssvc_a._bases(), pats, lens,
                                 *knobs)
        SH._sharded_topk_program(TOPK_K, ssvc_b._topk_max_df(MAX_BUF), MAX_BUF, MAX_BUF,
                                 ssvc_b.shards, ssvc_b._bases(), tpats, tlens, *tknobs)
        SH._sharded_tfidf_program(ssvc_b.coll.d, TOPK_K, False, TFIDF_MAX_BUF, ssvc_b.shards,
                                  ssvc_b._bases(), qpats, qlens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("[sharded] the plan, list, topk and tfidf programs (eager, every shard and the "
        "merge): no host sync")


def sharded_latency(cases, kernels, rounds=3):
    """Per-batch host seconds of each endpoint through the sharded and the
    flat service's graphs, in turns on the same batches (warm: nothing is
    captured); logs both p50s and their ratio, then one warm ``list_docs``
    and ``tfidf`` batch profiled on both sides (device ms, activities)."""
    times = {}
    with uncounted(kernels):
        for _ in range(rounds):
            for name, per_batch in cases.items():
                t = times.setdefault(name, {"sharded": [], "flat": []})
                for graph_fn, _, flat_fn in per_batch:
                    for side, fn in (("flat", flat_fn), ("sharded", graph_fn)):
                        t0 = time.perf_counter()
                        fn()
                        t[side].append(time.perf_counter() - t0)
    for name, t in times.items():
        s, f = np.median(t["sharded"]) * 1e3, np.median(t["flat"]) * 1e3
        log(f"[sharded] {name} per batch of 32, p50 ms: sharded {s:.3f}, flat {f:.3f}, "
            f"ratio {s / f:.2f}")
    # where a batch's time goes: one warm last batch profiled on both sides
    for name in ("8a list_docs[auto]", "8b tfidf[or]"):
        graph_fn, _, flat_fn = cases[name][-1]
        with uncounted(kernels):
            for side, fn in (("sharded", graph_fn), ("flat", flat_fn)):
                prof = profile_calls(fn, 1)
                log(f"[sharded] {name} {side} profile, last batch: wall {prof['wall_ms']:.3f} "
                    f"ms, device {prof['device_ms']} ms, {prof['kernels_per_call']:.0f} device "
                    f"activities")


def sharded_runtime(ssvc, batches, kernels, replay):
    """A short clean ``ServeRuntime`` pass over the sharded service: two warm
    passes, then each batch's answers full, equal to the direct endpoint
    call, and one replay's launches per batch."""
    from repro_torch.serve.runtime import RuntimeConfig, ServeRuntime

    cfg = RuntimeConfig(max_batch=RUNTIME_BATCH, k=TOPK_K, max_df=min(256, ssvc.coll.d + 1),
                        default_deadline_s=RUNTIME_DEADLINE_S)
    rt = ServeRuntime(ssvc, cfg)
    with uncounted(kernels):
        for mode in ("list", "count"):
            reqs = [[(mode, p) for p in b] for b in batches]
            for _ in range(2):
                for r in reqs:
                    rt.serve(r, deadline_s=1e9)
            lat = []
            for r in reqs:
                answers, dt = serve_counted(rt, ssvc, kernels, mode, r, replay)
                lat.append(dt * 1e3)
                require(all(a.path == "full" and not a.degraded and a.retries == 0
                            and not a.deadline_missed for a in answers), ("sharded runtime", mode))
                require([a.result for a in answers] == direct_answers(ssvc, cfg, mode,
                                                                      [p for _, p in r]),
                        ("sharded runtime", mode, "answer differs from the direct call"))
            log(f"[sharded] runtime {mode}: {len(reqs)} batches of {RUNTIME_BATCH}, clean, p50 "
                f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms")
    m = rt.metrics
    require(m.degraded == 0 and m.retries == 0 and m.failures == 0 and m.deadline_misses == 0,
            ("sharded runtime", m.as_dict()))


def tfidf_incremental_checks(tsvc, queries, pg):
    """``tfidf_topk_incremental`` on the card against the same call on a CPU
    copy of the index (the plain gather): equal documents and float64
    scores, one PDL gather launch per term.  Returns the launches."""
    from repro_torch.core.tfidf import tfidf_topk_incremental

    with uncounted((pg,)):
        plan = tsvc.plan([t for q in queries for t in q])
    ranges = np.stack([plan["lo"], plan["hi"]], axis=1).reshape(len(queries), 2, 2)
    cpu = [x.to("cpu") for x in (tsvc.pdl_topk, tsvc.csa, tsvc.sada)]
    pg.launches = 0  # the incremental loop's run starts here
    card_s, cpu_s = [], []
    for conj in (False, True):
        for r in ranges:
            t0 = time.perf_counter()
            got = tfidf_topk_incremental(tsvc.pdl_topk, tsvc.csa, tsvc.sada, r, TOPK_K, conj,
                                         max_buf=TFIDF_MAX_BUF)
            card_s.append(time.perf_counter() - t0)
            with uncounted((pg,)):
                t0 = time.perf_counter()
                want = tfidf_topk_incremental(*cpu, r, TOPK_K, conj, max_buf=TFIDF_MAX_BUF)
                cpu_s.append(time.perf_counter() - t0)
            require(got == want and len(got[0]) > 0,
                    ("tfidf_topk_incremental: card and CPU copy differ", conj, r.tolist()))
    require(pg.launches == 2 * ranges.shape[0] * ranges.shape[1],
            ("tfidf_topk_incremental launches", pg.launches))
    log(f"[sharded] tfidf_topk_incremental: {len(ranges)} two-term queries, OR and AND, k = "
        f"{TOPK_K}: documents and float64 scores equal to the CPU copy's; {pg.launches} PDL "
        f"gather launches (one per term); seconds per query: card p50 "
        f"{np.median(card_s):.4f}, CPU copy p50 {np.median(cpu_s):.4f}")
    return {"pdl_gather": pg.launches}


def phase_sharded(dev, full_svc, full_batches, topk, kernels):
    """Phase 8: the docs-sharded service on the collections of phases 2 and
    2b.  Returns the sharded path's and the incremental tf-idf's launches."""
    import dataclasses

    from repro_torch.errors import IndexIntegrityError
    from repro_torch.serve.validate import validate_sharded_service

    t_phase = time.perf_counter()
    replay = sharded_replay(SHARDS)
    tsvc, tbatches, tqueries = topk["svc"], topk["batches"], topk["tf_queries"]
    ssvc_a = build_sharded("8a", full_svc, dev, topk_index=False)
    ssvc_b = build_sharded("8b", tsvc, dev, topk_index=True)

    # no truncation: every row is the whole answer, whatever the shard split
    d = full_svc.coll.d
    max_df = d + 1
    with uncounted(kernels):
        occ = max(int(full_svc.plan(b)["occ"].max()) for b in full_batches)
    buf = max(MAX_BUF, 1 << (occ - 1).bit_length())
    da = full_svc.da.cpu().numpy()
    cases = {}
    for b in full_batches:
        for name, fns in sharded_calls_8a(ssvc_a, full_svc, b, max_df, buf).items():
            cases.setdefault(("8a", name), []).append(fns)
    for b, q in zip(tbatches, tqueries):
        for name, fns in sharded_calls_8b(ssvc_b, tsvc, b, q).items():
            cases.setdefault(("8b", name), []).append(fns)
    with uncounted(kernels):  # the flat service's answers, outside the counted run
        flat = {key: [f() for _, _, f in per] for key, per in cases.items()}
        for bi, b in enumerate(full_batches):
            plan = full_svc.plan(b)
            for e in ("auto", "ilcp", "brute", "pdl"):
                docs, cnt = flat[("8a", f"list_docs[{e}]")][bi]
                check_listing(docs, cnt, plan["lo"], plan["hi"], da, max_df)  # whole rows

    lat, warm = {}, {}
    reset_counts(kernels)  # the sharded path's run starts here
    for (label, name), per in cases.items():
        ssvc = ssvc_a if label == "8a" else ssvc_b
        for bi, (graph_fn, eager_fn, _) in enumerate(per):
            out = checked_call(ssvc, kernels, sharded_kinds(name), f"{label} {name}",
                               (graph_fn, eager_fn), lat, warm, replay)
            want = flat[(label, name)][bi]
            if name == "plan":
                require(np.array_equal(out["occ"], want["occ"])
                        and np.array_equal(out["df"], want["df"])
                        and np.array_equal((out["hi"] - out["lo"]).sum(0), want["occ"]),
                        (label, name, bi, "global occ/df differ from the flat service's"))
            else:
                require(same_bits(out, want),
                        (label, name, bi, "differs from the flat service's answer"))
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    require(set(launches) == {"backward_search", "ilcp_list", "pdl_gather"}, launches)
    require(all(n > 0 for n in warm.values()), ("a sharded endpoint made no warm call", warm))
    log(f"[sharded] {len(full_batches)} + {len(tbatches)} batches of 32 (8a: max_df {max_df}, "
        f"max_buf {buf}; 8b: k {TOPK_K}, max_buf {MAX_BUF} / {TFIDF_MAX_BUF}), every answer "
        f"equal to the flat service's, tf-idf scores bit for bit; launches {launches} (no "
        f"rank, no RMQ); warm calls {warm}")
    for label, ssvc in (("8a", ssvc_a), ("8b", ssvc_b)):
        log_programs(ssvc, f"sharded {label}", replay)
        per_kind = {}
        for kind, _ in ssvc.compiled_programs():
            per_kind[kind] = per_kind.get(kind, 0) + 1
        require(per_kind == ssvc.compile_counts, (label, "not one capture per bucket",
                                                  per_kind, ssvc.compile_counts))
    sharded_no_sync(ssvc_a, full_batches[0], max_df, buf, ssvc_b, tbatches[0], tqueries[0])
    sharded_latency({f"{label} {name}": per for (label, name), per in cases.items()}, kernels)

    log(f"[sharded] validate_sharded_service: 8a {ssvc_a.build_seconds['validate']:.3f} s, "
        f"8b {ssvc_b.build_seconds['validate']:.3f} s")
    shards = list(ssvc_a.shards)
    shards[1] = dataclasses.replace(shards[1], da=torch.full_like(shards[1].da, d + 9))
    try:
        validate_sharded_service(dataclasses.replace(ssvc_a, shards=shards))
        require(False, "a tampered shard passed validate_sharded_service")
    except IndexIntegrityError as e:
        log(f"[sharded] tampered shard 1: IndexIntegrityError({e})")
    sharded_runtime(ssvc_a, full_batches, kernels, replay)
    incremental = tfidf_incremental_checks(tsvc, tqueries[0], kernels[2])
    log(f"[sharded] phase body {time.perf_counter() - t_phase:.1f} s")
    return launches, incremental


# ---------------------------------------------------------------------------
# Phase 9: the analysis gate
# ---------------------------------------------------------------------------

AUDIT_BUCKETS = ((1, 8), (8, 8))   # the gate's own, on its audit collection
ANALYSIS_CLI_ARGS = ()             # extra flags of the gate's CLI run


def log_audit(label, report):
    """Each audited program's recorded launches and graph nodes."""
    for e in report["endpoints"]:
        g = e["graph_nodes"]
        nodes = (f"nodes {g['total']} (kernel {g['kernel']}, memcpy/memset "
                 f"{g['memcpy_memset']})" if g else "no graph")
        log(f"[analysis] {label} {e['contract']}: launches {e['launches']}, {nodes}, "
            f"outputs {'/'.join(sorted(set(e['output_dtypes'])))}")


def require_clean(label, report, violations, n, dev):
    """No violation, ``n`` programs audited, each with a graph on the card
    whose kernel nodes of the port's kernels equal the recorded calls (the
    audit's ``graph_kernels`` check; restated here)."""
    require(not violations, (label, [v.as_dict() for v in violations]))
    require(report["contracts_audited"] == n, (label, report["contracts_audited"]))
    for e in report["endpoints"]:
        g = e["graph_nodes"]
        require(g is not None or dev.type == "cpu", (label, e["contract"], "no graph"))
        if g is not None:
            ours = {k[: -len("_kernel")]: c for k, c in g["kernels"].items()
                    if k[: -len("_kernel")] in e["expected_launches"]}
            require(ours == e["launches"] == e["expected_launches"],
                    (label, e["contract"], ours, e["launches"]))


def phase_analysis(full_svc):
    """Phase 9: ``repro_torch.analysis`` on the card.  (a) Its audit
    collection, flat and as 4 shards, at the gate's buckets; (b) phase 2's
    service at its batches' bucket and settings, the automatic window's
    ``list`` program beside the audited pinned one; (c) a seeded contract
    violation; (d) the gate's CLI as a subprocess."""
    from repro_torch.analysis import contracts
    from repro_torch.analysis.programs import trace_program
    from repro_torch.analysis.report import build_audit_services
    from repro_torch.serve.retrieval import BRUTE_WINDOW_FLOOR

    t_phase = time.perf_counter()
    dev = full_svc.device
    mode = torch.cuda.get_sync_debug_mode()
    flat, sharded = build_audit_services(dev)
    for label, svc, audit in (("flat", flat, contracts.audit_service),
                              ("sharded", sharded, contracts.audit_sharded_service)):
        report, violations = audit(svc, buckets=AUDIT_BUCKETS)
        require_clean(f"audit {label}", report, violations, 4 * len(AUDIT_BUCKETS), dev)
        log_audit(f"audit collection {label}", report)
    require(torch.cuda.get_sync_debug_mode() == mode, "the audit left the sync debug mode set")

    bucket = (32, 8)  # phase 2's batches: 32 patterns of length 6
    report, violations = contracts.audit_service(full_svc, buckets=(bucket,), max_df=MAX_DF,
                                                 max_buf=MAX_BUF)
    require_clean("phase 2", report, violations, 2, dev)
    log_audit(f"phase 2 (n={full_svc.coll.n}, max_df {MAX_DF}, max_buf {MAX_BUF})", report)
    nodes = {e["contract"].split("/")[0]: e["graph_nodes"] for e in report["endpoints"]}
    win = full_svc._brute_windows.get(("list", (bucket, MAX_DF, MAX_BUF)))
    if win is not None and nodes["list"] is not None:
        auto = trace_program("list", bucket, full_svc._list_fn(MAX_DF, win, MAX_BUF),
                             full_svc._audit_batch(*bucket)).graph
        require(auto.kernels.get("backward_search_kernel") == 1, auto.kernels)
        log(f"[analysis] phase 2 list program at the automatic window {win} (pinned: "
            f"{min(BRUTE_WINDOW_FLOOR, MAX_BUF)}): nodes {auto.total} (kernel {auto.kernel_nodes}, "
            f"memcpy/memset {auto.copies}); a warm list_docs[auto] batch replays it and the "
            f"plan graph ({nodes['plan']['total']} nodes): {auto.total + nodes['plan']['total']}"
            f" nodes, against the pinned program's {nodes['list']['total']}")

    trace = full_svc.trace_endpoint("plan", *bucket)
    good = contracts.build_registry(full_svc, (bucket,))[0]
    bad = contracts.EndpointContract("plan", bucket, dev.type,
                                     {**good.launches, "backward_search": 2})
    seeded = contracts.audit_trace(trace, bad)
    require([v.check for v in seeded] == ["launches"], [v.as_dict() for v in seeded])
    require(not contracts.audit_trace(trace, good), "the true contract failed")
    log(f"[analysis] seeded contract (2 backward searches per plan): {seeded[0].message}")
    # a launch no wrapper recorded: the second search of this program runs
    # with the recorder of its wrapper silenced, so only the graph shows it
    import repro_torch.kernels.backward_search as bs_mod

    fn, args = full_svc.endpoint_program("plan")

    def uncounted_search(*a):
        out = fn(*a)
        bs_mod.record = lambda *_: None
        try:
            fn(*a)
        finally:
            bs_mod.record = record
        return out

    record = bs_mod.record
    hidden = contracts.audit_trace(
        trace_program("plan", bucket, uncounted_search, args(*bucket)), good)
    require([v.check for v in hidden] == (["graph_kernels"] if dev.type == "cuda" else []),
            [v.as_dict() for v in hidden])
    if hidden:
        log(f"[analysis] seeded unrecorded launch: {hidden[0].message}")

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "analysis.json")
        cmd = [sys.executable, "-m", "repro_torch.analysis", "--report", path,
               *ANALYSIS_CLI_ARGS]
        t = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=300)
        require(out.returncode == 0, (cmd, out.returncode, out.stderr[-3000:]))
        with open(path) as f:
            cli = json.load(f)
    require(cli["ok"] and cli["contracts"]["contracts_audited"] == 8
            and cli["contracts_sharded"]["contracts_audited"] == 8, cli.get("ok"))
    log(f"[analysis] python -m repro_torch.analysis: exit 0 in "
        f"{time.perf_counter() - t:.1f} s; {out.stdout.strip()}")
    log(f"[analysis] phase body {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: the recsys family served and trained at full width
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("fm", "sasrec", "autoint", "dlrm-mlperf")
RECSYS_SERVE = {"serve_p99": 512, "serve_bulk": 262_144}   # the registry's batches
RECSYS_CANDIDATES = 1_000_000      # the registry's retrieval_cand
#: retrieval calls the 1M candidates are split into (activations under 80 GB)
RECSYS_RETRIEVAL_CHUNKS = {"fm": 1, "sasrec": 1, "autoint": 4, "dlrm-mlperf": 2}
RECSYS_REPS = {"serve_p99": 20, "serve_bulk": 5, "retrieval_cand": 3}
RECSYS_TRAIN_BATCH = 65_536        # the registry's train_batch
RECSYS_TRAIN_STEPS = 8
#: DLRM trains with each table capped at this many rows: AdamW's functional
#: update holds about 12 table-sized f32 buffers at its peak
RECSYS_DLRM_TRAIN_CAP = 1 << 20
RECSYS_CHECK_CANDIDATES = 1024
#: retrieval against the batch entry point with bf16 tables: 4 bf16 ulps of
#: the largest score (tests/test_torch_recsys.py measures the reference's
#: own gap at reduced width, at most 3.5e-3 of it, and holds it to this;
#: FM's at full width is about 1.1e-2)
RECSYS_GAP_REL = 2.0 ** -6
#: FM's table gradients through the kernel against an f64 gradient (plain
#: autograd in f64), in relative norm
RECSYS_GRAD_RTOL = 1e-6
RECSYS_CLI_STEPS = 20
RECSYS_CLI_ARCHS = ("dlrm-mlperf", "sasrec")
RECSYS_CLI_ARGS = ()               # extra flags of the training CLI's runs
#: embedding-bag launches per call of each entry point (one per lookup)
RECSYS_LOOKUPS = {
    ("fm", "score"): 2, ("fm", "retrieval"): 4, ("fm", "train"): 2,
    ("sasrec", "score"): 2, ("sasrec", "retrieval"): 2, ("sasrec", "train"): 3,
    ("autoint", "score"): 1, ("autoint", "retrieval"): 2, ("autoint", "train"): 1,
    ("dlrm-mlperf", "score"): 1, ("dlrm-mlperf", "retrieval"): 2, ("dlrm-mlperf", "train"): 1,
}


def recsys_batch(arch, cfg, B, seed, dev=None):
    """A ``recsys_batches`` batch of ``B``, on ``dev`` (numpy arrays for
    ``None``); SASRec: sequences, their positives and negatives, and
    ``target``, each sequence's last positive."""
    from repro_torch.data.pipelines import recsys_batches

    if arch == "sasrec":
        b = next(recsys_batches((), B, seq_len=cfg.seq_len, n_items=cfg.n_items, seed=seed))
        b["target"] = b["pos_items"][:, -1].copy()
    else:
        b = next(recsys_batches(cfg.vocab_sizes, B, n_dense=getattr(cfg, "n_dense", 0),
                                seed=seed))
    if dev is None:
        return b
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def recsys_score(R, arch, cfg, params, b):
    """The entry point that scores a batch: ``*_logits`` or
    ``sasrec_serve``."""
    if arch == "sasrec":
        return R.sasrec_serve(cfg, params, {"item_seq": b["item_seq"], "target": b["target"]})
    if arch == "dlrm-mlperf":
        return R.dlrm_logits(cfg, params, b["dense"], b["sparse"])
    return getattr(R, f"{arch}_logits")(cfg, params, b["sparse"])


def recsys_retrieve(R, arch, cfg, params, user, cand, field):
    """``*_retrieval`` of the batch ``user``'s first row against ``cand``."""
    if arch == "sasrec":
        return R.sasrec_retrieval(cfg, params, user["item_seq"][:1], cand)
    if arch == "dlrm-mlperf":
        return R.dlrm_retrieval(cfg, params, user["dense"][0], user["sparse"][0], cand, field)
    return getattr(R, f"{arch}_retrieval")(cfg, params, user["sparse"][0], cand, field)


def recsys_filled_in(arch, user, cand, field):
    """``user``'s first row with each of ``cand`` filled into ``field`` (the
    target for SASRec), as a batch for ``recsys_score``."""
    n = cand.numel()
    if arch == "sasrec":
        return {"item_seq": user["item_seq"][:1].expand(n, -1).contiguous(), "target": cand}
    out = {"sparse": user["sparse"][:1].repeat(n, 1)}
    out["sparse"][:, field] = cand
    if arch == "dlrm-mlperf":
        out["dense"] = user["dense"][:1].repeat(n, 1)
    return out


def recsys_ids(R, arch, cfg, b):
    """The global row ids a batch looks up in its model's big table."""
    if arch == "sasrec":
        return torch.cat([b["item_seq"].reshape(-1), b["target"].reshape(-1)])
    offsets, _ = R._field_offsets(cfg.vocab_sizes, b["sparse"].device)
    return (b["sparse"] + offsets[None, :]).reshape(-1)


def check_lookup_bits(R, eb, table, ids, label):
    """``lookup`` through the kernel against ``table[ids]``, bit for bit
    (uncounted: a comparison, not the main path); also the table's last
    rows, whose element offsets pass 2^31 on the big tables."""
    rows = table.shape[0]
    ids = torch.cat([ids.reshape(-1), torch.arange(max(rows - 3, 0), rows, device=ids.device,
                                                    dtype=ids.dtype)])
    with uncounted([eb]):
        before = eb.launches
        got = R.lookup(table, ids)
        launched = eb.launches - before
        want = table[ids.long()]
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[table.dtype]
    require(launched == 1, (label, "lookup launches", launched))
    require(got.dtype == table.dtype and torch.equal(got.view(bits), want.view(bits)),
            (label, "lookup is not table[ids] bit for bit"))
    return ids.numel()


def lookup_alone(R, eb, table, ids, arch, reps=10):
    """``lookup(table, ids)`` timed alone (uncounted) by CUDA events beside
    the library calls of ``bag_library_calls`` on the ids as int32 bags of
    one (``table[ids]``, ``index_select``, ``F.embedding_bag``) and the
    plain version, with the byte and sector bounds: back to back (``*ms``)
    and queued behind a spin kernel (``*device_ms``: no host time between
    calls)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain

    bags = ids.reshape(-1, 1).to(torch.int32).contiguous()
    r = {"table": list(table.shape), "rows": bags.shape[0]}
    fk = lambda: R.lookup(table, ids)  # noqa: E731
    with uncounted([eb]):
        r.update(ms=cuda_time_ms(fk, reps), device_ms=queued_time_ms(fk, reps),
                 **time_calls(bag_library_calls(table, bags), reps),
                 bag_plain_ms=cuda_time_ms(lambda: embedding_bag_plain(table, bags), 2))
    r["bound_ms"], r["sector_bound_ms"] = bag_bounds_ms(table, bags)
    log(f"[recsys] {arch} lookup of the bulk batch's {r['rows']:,} ids on {r['table']}, ms "
        f"(device ms): kernel {r['ms']:.4f} ({r['device_ms']:.4f}), table[ids] "
        f"{r['gather_ms']:.4f} ({r['gather_device_ms']:.4f}), index_select "
        f"{r['index_select_ms']:.4f} ({r['index_select_device_ms']:.4f}), F.embedding_bag "
        f"{r['library_ms']:.4f} ({r['library_device_ms']:.4f}), plain version "
        f"{r['bag_plain_ms']:.4f}; byte bound {r['bound_ms']:.4f} ms, sector bound "
        f"{r['sector_bound_ms']:.4f} ms")
    return r


def timed_calls(fn, reps):
    """(median ms of ``reps`` warm calls, host clock around a synchronised
    call, the last call's output)."""
    out = fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), out


def big_tables(R, params):
    """The tree's 2-D leaves of 65,536 rows or more: the embedding tables
    (bf16 in the serving copy)."""
    from repro_torch.train.tree import flatten

    return [t for t in flatten(params)[0] if t.dim() == 2 and t.shape[0] >= R.LARGE_TABLE_ROWS]


def serving_copy(R, init, cfg, gen, dev):
    """The registry's serving copy: 2-D leaves of 65,536 rows or more in
    bf16, the rest f32.  Every leaf is drawn in bf16 (DLRM's 187,767,808 x
    128 table straight in bf16: 96 GB in f32 would not fit the card), then
    the small ones are cast to f32."""
    import dataclasses

    from repro_torch.train.tree import map_leaves

    p = init(dataclasses.replace(cfg, param_dtype=torch.bfloat16), gen, dev)
    return map_leaves(lambda t: t if t.dim() == 2 and t.shape[0] >= R.LARGE_TABLE_ROWS
                      else t.float(), p)


def recsys_serve(R, eb, arch, cfg, init, dev, serve, n_cand, chunks):
    """(a) for one model: its serving copy, ``serve`` batches through the
    scoring entry point and one user against ``n_cand`` candidates, each
    call's launches, the lookups bit for bit, retrieval against the
    scoring entry point on the first candidates."""
    from repro_torch.train.tree import flatten

    gen = torch.Generator(device=dev).manual_seed(0)
    free_device_memory()
    t0 = time.perf_counter()
    params = serving_copy(R, init, cfg, gen, dev)
    torch.cuda.synchronize()
    leaves = flatten(params)[0]
    tables = big_tables(R, params)
    table = max(tables, key=lambda t: t.numel())
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    out = {"params_gb": nbytes / 1e9, "table": list(table.shape),
           "table_dtype": str(table.dtype), "init_s": time.perf_counter() - t0}
    log(f"[recsys] {arch}: serving copy {nbytes / 1e9:.3f} GB (largest table "
        f"{table.shape[0]:,} x {table.shape[1]} {table.dtype}) in {out['init_s']:.2f} s")
    checked = 0
    for shape, B in serve.items():
        b = recsys_batch(arch, cfg, B, seed=1, dev=dev)
        torch.cuda.reset_peak_memory_stats()
        before = eb.launches
        ms, s = timed_calls(lambda b=b: recsys_score(R, arch, cfg, params, b),
                            RECSYS_REPS[shape])
        calls = RECSYS_REPS[shape] + 1
        per_call = (eb.launches - before) / calls
        require(per_call == RECSYS_LOOKUPS[(arch, "score")], (arch, shape, "launches", per_call))
        require(s.shape == (B,) and s.dtype == torch.float32 and bool(torch.isfinite(s).all()),
                (arch, shape, "scores", s.shape, s.dtype))
        out[shape] = {"batch": B, "ms": ms, "rows_per_s": B / ms * 1e3,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches_per_call": per_call}
        checked += sum(check_lookup_bits(R, eb, t, recsys_ids(R, arch, cfg, b), (arch, shape))
                       for t in tables)
        log(f"[recsys] {arch} {shape} B={B:,}: {ms:.3f} ms ({B / ms * 1e3:,.0f} rows/s), "
            f"peak {out[shape]['peak_gib']:.2f} GiB, {per_call:.0f} embedding-bag launches a call")
        del b, s
    # retrieval: the first user of a seeded batch against n_cand candidates
    # of the model's largest field (SASRec: items), in ``chunks`` calls
    user = recsys_batch(arch, cfg, 4, seed=2, dev=dev)
    if arch == "sasrec":
        field, hi, lo = None, cfg.n_items + 1, 1
    else:
        field = 0 if arch == "dlrm-mlperf" else int(np.argmax(cfg.vocab_sizes))
        hi, lo = cfg.vocab_sizes[field], 0
    cand = torch.randint(lo, hi, (n_cand,), generator=gen, device=dev, dtype=torch.int32)
    parts = cand.chunk(chunks)
    torch.cuda.reset_peak_memory_stats()
    before = eb.launches
    ms, scores = timed_calls(lambda: torch.cat([recsys_retrieve(
        R, arch, cfg, params, user, c, field) for c in parts]), RECSYS_REPS["retrieval_cand"])
    calls = (RECSYS_REPS["retrieval_cand"] + 1) * len(parts)
    per_call = (eb.launches - before) / calls
    require(per_call == RECSYS_LOOKUPS[(arch, "retrieval")], (arch, "retrieval launches",
                                                              per_call))
    require(scores.shape == (n_cand,) and scores.dtype == torch.float32
            and bool(torch.isfinite(scores).all()), (arch, "retrieval scores"))
    out["retrieval_cand"] = {"candidates": n_cand, "chunks": len(parts), "field": field,
                             "ms": ms, "rows_per_s": n_cand / ms * 1e3,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "launches_per_call": per_call}
    # the first candidates scored by the batch entry point (not the main
    # path's traffic: uncounted)
    k = min(RECSYS_CHECK_CANDIDATES, n_cand)
    with uncounted([eb]):
        want = recsys_score(R, arch, cfg, params, recsys_filled_in(arch, user, cand[:k], field))
    gap = float((scores[:k] - want).abs().max())
    scale = float(want.abs().max())
    out["retrieval_cand"].update(gap=gap, gap_rel=gap / max(scale, 1e-30), score_scale=scale)
    require(gap <= RECSYS_GAP_REL * scale, (arch, "retrieval against the scoring entry point",
                                            gap, scale))
    checked += sum(check_lookup_bits(R, eb, t, cand, (arch, "retrieval")) for t in tables)
    out["lookup_rows_checked"] = checked
    of = "items" if field is None else f"field {field}"
    log(f"[recsys] {arch} retrieval_cand: 1 user x {n_cand:,} candidates ({of}) in "
        f"{len(parts)} call(s): {ms:.3f} ms ({n_cand / ms * 1e3:,.0f} candidates/s), peak "
        f"{out['retrieval_cand']['peak_gib']:.2f} GiB; first {k} against the scoring entry "
        f"point: max |diff| {gap:.3e} of scores up to {scale:.3e} (tolerance "
        f"{RECSYS_GAP_REL} of it); {checked:,} lookups equal to table[ids] bit for bit")
    # the lookup alone at the bulk batch's ids, on each big table: the kernel
    # beside the plain gather, index_select, F.embedding_bag and the plain version
    ids = recsys_ids(R, arch, cfg, recsys_batch(arch, cfg, serve["serve_bulk"], 1, dev))
    out["lookup"] = [lookup_alone(R, eb, t, ids, arch) for t in tables]
    del params, table, tables, leaves, scores, cand, parts, ids
    free_device_memory()
    return out


def recsys_train(R, eb, arch, cfg, init, loss, dev, batch, steps):
    """(b) for one model: ``steps`` f32 AdamW steps through ``train`` on
    ``batch`` rows a step, the launches of each step, finite losses; for
    FM, the first batch's table gradients through the kernel, and by plain
    ``table[ids]`` autograd, against an f64 gradient."""
    from repro_torch.train.loop import train, value_and_grad
    from repro_torch.train.tree import flatten, map_leaves

    gen = torch.Generator(device=dev).manual_seed(0)
    free_device_memory()
    params = init(cfg, gen, dev)
    n_params = sum(t.numel() for t in flatten(params)[0])
    batches = [recsys_batch(arch, cfg, batch, 10 + s) for s in range(steps)]
    for b in batches:
        b.pop("target", None)
    first = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    ids = recsys_ids(R, arch, cfg, {**first, "target": first.get("pos_items")})
    checked = sum(check_lookup_bits(R, eb, t, ids, (arch, "train"))
                  for t in big_tables(R, params))
    marks = []

    def batch_fn(step):
        marks.append(eb.launches)
        return batches[step]

    def loss_fn(p, b):
        return loss(cfg, p, b)

    out = {"lookup_rows_checked": checked}
    if arch == "fm":
        with uncounted([eb]):
            _, got = value_and_grad(loss_fn, params, first)
            orig = R.lookup
            R.lookup = lambda t, i: t[i.long()]  # plain autograd: index_put's sums
            try:
                _, plain = value_and_grad(loss_fn, params, first)
                _, exact = value_and_grad(loss_fn, map_leaves(torch.Tensor.double, params),
                                          {k: v.double() if v.is_floating_point() else v
                                           for k, v in first.items()})
            finally:
                R.lookup = orig
        errs = {key: {"kernel_vs_f64": rel_norm(got[key], exact[key]),
                      "plain_vs_f64": rel_norm(plain[key], exact[key]),
                      "kernel_vs_plain": rel_norm(got[key], plain[key])} for key in ("emb", "lin")}
        out["grad_rel"] = errs
        require(all(e["kernel_vs_f64"] <= RECSYS_GRAD_RTOL for e in errs.values()),
                ("FM table gradients through the kernel against the f64 gradient", errs))
        require(float(got["emb"].abs().max()) > 0, "FM: no table gradient")
        log("[recsys] fm: the first batch's table gradients in relative norm, through the "
            "kernel / plain f32 table[ids] autograd against the f64 gradient, and kernel "
            "against plain: " + "; ".join(
                f"{k} {e['kernel_vs_f64']:.2e} / {e['plain_vs_f64']:.2e}, "
                f"{e['kernel_vs_plain']:.2e}" for k, e in errs.items())
            + f" (tolerance {RECSYS_GRAD_RTOL} against f64)")
        del got, plain, exact
    del first, ids
    held = [params]  # the loop owns the parameters (AdamW's update frees them)
    del params
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train(loss_fn, held.pop, batch_fn, n_steps=steps, ckpt_dir=ckpt,
                    ckpt_every=steps, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    marks.append(eb.launches)
    per_step = [b - a for a, b in zip(marks, marks[1:])]
    require(per_step == [RECSYS_LOOKUPS[(arch, "train")]] * steps, (arch, "launches a step",
                                                                    per_step))
    require(len(res.losses) == steps and all(np.isfinite(res.losses)), (arch, res.losses))
    med = float(np.median(res.step_seconds[1:]))
    out.update(batch=batch, steps=steps, losses=res.losses, step_seconds=res.step_seconds,
               step_median_s=med, rows_per_s=batch / med,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, run_s=run_s,
               launches_per_step=per_step[0], params=n_params)
    log(f"[recsys] {arch} train: {steps} f32 steps of {batch:,} rows in {run_s:.2f} s (the "
        f"last step's checkpoint included): losses " + " ".join(f"{x:.4f}" for x in res.losses)
        + f"; median of steps 2-{steps} {med:.4f} s ({batch / med:,.0f} rows/s); peak "
        f"{out['peak_gib']:.2f} GiB; {per_step[0]} embedding-bag launches a step")
    del res
    free_device_memory()
    return out


def phase_recsys(dev, eb, configs=None, serve=RECSYS_SERVE, n_cand=RECSYS_CANDIDATES,
                 chunks=RECSYS_RETRIEVAL_CHUNKS, train_batch=RECSYS_TRAIN_BATCH,
                 steps=RECSYS_TRAIN_STEPS, dlrm_cap=RECSYS_DLRM_TRAIN_CAP,
                 cli_steps=RECSYS_CLI_STEPS):
    """Phase 12: FM, SASRec, AutoInt and DLRM-MLPerf at their published
    widths (``configs``: arch -> config, default each ``config()``).  (a)
    serving on the registry's shapes in the serving copy, (b) training in
    f32 (DLRM's tables capped at ``dlrm_cap`` rows), (c) the training CLI
    for two archs.  Returns the launches of (a) and (b) and the numbers."""
    import dataclasses

    from repro_torch.configs.registry import get_arch_module
    from repro_torch.launch.train import RECSYS
    from repro_torch.models import recsys as R

    t_phase = time.perf_counter()
    configs = configs or {a: get_arch_module(a).config() for a in RECSYS_ARCHS}
    runs = {"card": nvidia_smi_line(), "serve": {}, "train": {}}
    eb.launches = 0  # the recsys path's run starts here
    for arch, cfg in configs.items():
        runs["serve"][arch] = recsys_serve(R, eb, arch, cfg, RECSYS[arch][0], dev, serve,
                                           n_cand, chunks[arch])
    for arch, cfg in configs.items():
        if arch == "dlrm-mlperf":
            cfg = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, dlrm_cap)
                                                             for v in cfg.vocab_sizes))
            log(f"[recsys] dlrm-mlperf train: reduced: each table capped at {dlrm_cap:,} rows "
                f"({sum(cfg.vocab_sizes):,} rows of {sum(R.MLPERF_TABLE_SIZES):,}); widths "
                "as published")
        runs["train"][arch] = recsys_train(R, eb, arch, cfg, *RECSYS[arch], dev, train_batch,
                                           steps)
    launches = {"embedding_bag": eb.launches}
    runs["launches"] = eb.launches
    # (c) the CLI, on the reduced configs
    runs["cli"] = {}
    for arch in RECSYS_CLI_ARCHS:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt:
            res = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                 "--steps", str(cli_steps), "--ckpt", ckpt, *RECSYS_CLI_ARGS],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                capture_output=True, text=True, timeout=300)
        require(res.returncode == 0, (arch, "training CLI", res.returncode, res.stderr[-2000:]))
        line = res.stdout.strip().splitlines()[-1]
        require(line.startswith(f"[{arch}] steps={cli_steps} loss "), ("CLI output", line))
        runs["cli"][arch] = time.perf_counter() - t0
        log(f"[recsys] (c) python -m repro_torch.launch.train --arch {arch} --steps "
            f"{cli_steps}: exit 0 in {runs['cli'][arch]:.1f} s; {line}")
    runs["phase_s"] = time.perf_counter() - t_phase
    log(f"[recsys] phase body {runs['phase_s']:.1f} s; {eb.launches:,} embedding-bag launches "
        f"on the path; {nvidia_smi_line()}")
    return launches, runs

# ---------------------------------------------------------------------------
# Phase 13: NequIP
# ---------------------------------------------------------------------------

NEQUIP_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")   # trained on one card
NEQUIP_OGB = "ogb_products"        # the forward alone: training needs A12.2b
NEQUIP_STEPS = 8
NEQUIP_F64_SHAPES = ("full_graph_sm", "molecule")
#: node features (s, v) against each other, of the largest magnitude: under a
#: rotation of edge_vec (s invariant, v against v R^T) and at 1 against the
#: shape's edge chunks; f32 rounding and the order of ``index_add_`` (atomics
#: on the card) and of the einsums (measured on the CPU at full width: up to
#: 3.6e-7; on an H100: up to 5.1e-7)
NEQUIP_NODE_RTOL = 1e-5
#: a graph's energy sums its n nodes' energies, on the card with atomics in
#: any order, and f32 rounding walks about 2^-24 sqrt(n) of the total: the
#: energies (against the CPU's f64 run, under a rotation, at 1 chunk) are
#: held within NEQUIP_NODE_RTOL + NEQUIP_SUM_ULPS 2^-24 sqrt(n) of the
#: largest |energy|, the loss within twice that, relative (minibatch_lg, n =
#: 169,984 in one graph: 2.1e-4 allowed; on an H100 a rotation moved its
#: energy by 9.5e-8 in one run and 1.13e-5 in another, 1 chunk by up to 1.4e-5)
NEQUIP_SUM_ULPS = 8
#: live bytes one edge of a chunk takes in the forward (w [E, 320], the
#: gathered s/v/t, the three messages and the l = 2 intermediates), for
#: choosing ogb_products' chunk count
NEQUIP_EDGE_BYTES = 12 * 1024
#: copies of the node state s/v/t (13 floats a channel) live at once in a
#: layer: the inputs, the running sums, a chunk's sums, the new sums, the
#: mixes and the outputs
NEQUIP_NODE_COPIES = 8
NEQUIP_OGB_CHUNKS = (8, 16, 32, 64)
NEQUIP_SAMPLE = (1024, (15, 10))   # minibatch_lg's seeds and fanouts
NEQUIP_CLI_STEPS = 3
NEQUIP_CLI_ARGS = ("--device", "cuda")


def nequip_graph(info, dev, seed=0):
    """The registry shape's random graph (``random_graph``) on ``dev`` and
    its host seconds."""
    from repro_torch.data.pipelines import random_graph

    t0 = time.perf_counter()
    g = random_graph(info["n_nodes"], info["n_edges"], info["d_feat"],
                     n_graphs=info["n_graphs"], seed=seed)
    host_s = time.perf_counter() - t0
    return {k: torch.as_tensor(v, device=dev) for k, v in g.items()}, host_s


def nequip_energy(nq, cfg, params, b, n_graphs, chunks, edge_vec=None):
    return nq.forward_energy(cfg, params, b["node_feat"], b["edge_index"],
                             b["edge_vec"] if edge_vec is None else edge_vec, b["graph_id"],
                             n_graphs, n_edge_chunks=chunks)


def rel_max(got, want) -> float:
    """max |got - want| over max |want|, in f64."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).abs().max() / w.abs().max())


def random_rotation(seed) -> torch.Tensor:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return torch.as_tensor((q * np.sign(np.linalg.det(q))).astype(np.float32))


def nequip_energy_rtol(info) -> float:
    """The energies' tolerance, of the largest |energy| (NEQUIP_SUM_ULPS)."""
    n = info["n_nodes"] / info["n_graphs"]
    return NEQUIP_NODE_RTOL + NEQUIP_SUM_ULPS * 2.0**-24 * math.sqrt(n)


def nequip_checks(nq, cfg, params, b, shape, info, chunks):
    """f64 on the CPU, rotation, chunk counts; each check raises on failure."""
    from repro_torch.train.tree import map_leaves

    G = info["n_graphs"]
    e_tol = nequip_energy_rtol(info)
    out = {"energy_rtol": e_tol}
    with torch.no_grad():
        e = nequip_energy(nq, cfg, params, b, G, chunks)
        loss = nq.forward_train(cfg, params, b, G, n_edge_chunks=chunks)
        if shape in NEQUIP_F64_SHAPES:
            p64 = map_leaves(lambda x: x.cpu().double(), params)
            b64 = {k: v.cpu().double() if v.is_floating_point() else v.cpu() for k, v in b.items()}
            e64 = nequip_energy(nq, cfg, p64, b64, G, chunks)
            loss64 = nq.forward_train(cfg, p64, b64, G, n_edge_chunks=chunks)
            out["f64_energy_rel"] = rel_max(e, e64)
            out["f64_loss_rel"] = abs(float(loss) - float(loss64)) / abs(float(loss64))
            require(out["f64_energy_rel"] <= e_tol and out["f64_loss_rel"] <= 2 * e_tol,
                    (shape, "f64", out))
        R = random_rotation(1).to(b["edge_vec"].device)
        args = (cfg, params, b["node_feat"], b["edge_index"])
        s, v, _ = nq._node_states(*args, b["edge_vec"], chunks)
        s_r, v_r, _ = nq._node_states(*args, b["edge_vec"] @ R.T, chunks)
        out["rotation_s_rel"] = rel_max(s_r, s)
        out["rotation_v_rel"] = rel_max(v_r, v @ R.T)
        del s_r, v, v_r
        out["rotation_energy_rel"] = rel_max(
            nequip_energy(nq, cfg, params, b, G, chunks, edge_vec=b["edge_vec"] @ R.T), e)
        require(out["rotation_s_rel"] <= NEQUIP_NODE_RTOL
                and out["rotation_v_rel"] <= NEQUIP_NODE_RTOL
                and out["rotation_energy_rel"] <= e_tol, (shape, "rotation", out))
        if chunks > 1:
            out["chunks_1_s_rel"] = rel_max(nq._node_states(*args, b["edge_vec"], 1)[0], s)
            out["chunks_1_energy_rel"] = rel_max(nequip_energy(nq, cfg, params, b, G, 1), e)
            require(out["chunks_1_s_rel"] <= NEQUIP_NODE_RTOL
                    and out["chunks_1_energy_rel"] <= e_tol, (shape, "chunks", out))
    require(bool(torch.isfinite(e).all()) and tuple(e.shape) == (G,), (shape, "energies"))
    out["energy_absmax"] = float(e.abs().max())
    out["loss"] = float(loss)
    return out


def nequip_roofline(shape):
    """The registry cell's one-card roofline terms (its analytic model is
    the train step's)."""
    from repro_torch.configs.registry import build_cell
    from repro_torch.dist.roofline import roofline_terms

    return roofline_terms(build_cell("nequip", shape).meta, 1, 0.0).row()


def nequip_train_shape(nq, cfgmod, dev, shape, info, steps):
    """One registry shape: the forward, the checks, ``steps`` AdamW steps
    through ``train``, one step profiled."""
    from repro_torch.train.loop import train, value_and_grad
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

    free_device_memory()
    cfg = cfgmod.config(d_feat_in=info["d_feat"])
    N, G, chunks = info["n_nodes"], info["n_graphs"], info["edge_chunks"]
    b, host_s = nequip_graph(info, dev)
    params = nq.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {"nodes": N, "edges": info["n_edges"], "d_feat": info["d_feat"], "graphs": G,
           "chunks": chunks, "graph_host_s": host_s}
    with torch.no_grad():
        nequip_energy(nq, cfg, params, b, G, chunks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nequip_energy(nq, cfg, params, b, G, chunks)
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
    out.update(nequip_checks(nq, cfg, params, b, shape, info, chunks))

    def loss_fn(p, batch):
        return nq.forward_train(cfg, p, batch, G, n_edge_chunks=chunks)

    opt_cfg = AdamWConfig()
    state = adamw_init(params, opt_cfg)

    def one_step():
        _, grads = value_and_grad(loss_fn, params, b)
        adamw_update(opt_cfg, params, grads, state)

    prof = profile_calls(one_step, 2)
    out["profile"] = {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                      "by_class_ms": device_ms_by_class(prof)}
    del state
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.reset_peak_memory_stats()
        res = train(loss_fn, lambda: params, lambda step: b, n_steps=steps, ckpt_dir=ckpt,
                    ckpt_every=steps, device=dev)
    require(len(res.losses) == steps and all(np.isfinite(res.losses)), (shape, res.losses))
    med = float(np.median(res.step_seconds[1:]))
    out.update(losses=res.losses, step_seconds=res.step_seconds, step_median_s=med,
               nodes_per_s=N / med, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               roofline=nequip_roofline(shape))
    rl = out["roofline"]
    log(f"[nequip] {shape}: {N:,} nodes, {info['n_edges']:,} edges, {info['d_feat']} features, "
        f"{G} graphs, {chunks} edge chunks; forward {out['forward_s']:.4f} s; {steps} AdamW "
        f"steps, losses " + " ".join(f"{x:.4g}" for x in res.losses)
        + f"; median of steps 2-{steps} {med:.4f} s ({N / med:,.0f} nodes/s); peak "
        f"{out['peak_gib']:.2f} GiB; one step profiled: wall {prof['wall_ms']:.2f} ms, device "
        f"{prof['device_ms'] or 0:.2f} ms (" + ", ".join(
            f"{k} {v:.2f}" for k, v in out["profile"]["by_class_ms"].items()) + "); roofline "
        f"(one card, the train step's analytic model): compute {rl['compute_s']:.3e} s, memory "
        f"{rl['memory_s']:.3e} s, dominant {rl['dominant']}")
    log(f"[nequip] {shape} checks: " + ", ".join(
        f"{k} {v:.3e}" for k, v in out.items() if k.endswith("_rel"))
        + f" (tolerances: node features {NEQUIP_NODE_RTOL}, energies "
        f"{out['energy_rtol']:.3e}, the loss twice that); |energy| up to "
        f"{out['energy_absmax']:.4g}")
    del res, b, params
    return out


def nequip_ogb_chunks(info, cfg, free_bytes) -> int:
    """The fewest edge chunks (of ``NEQUIP_OGB_CHUNKS``, dividing E) whose
    chunk fits beside the node state and the inputs in ``free_bytes``."""
    N, E, F = info["n_nodes"], info["n_edges"], info["d_feat"]
    node = N * cfg.channels * 13 * 4
    fixed = NEQUIP_NODE_COPIES * node + E * (2 * 4 + 3 * 4 + 13 * 4) + N * F * 4
    for c in NEQUIP_OGB_CHUNKS:
        if E % c == 0 and fixed + E // c * NEQUIP_EDGE_BYTES <= free_bytes:
            return c
    raise RuntimeError(f"no chunk count of {NEQUIP_OGB_CHUNKS} fits {free_bytes / 2**30:.1f} GiB")


def nequip_ogb(nq, cfgmod, dev, info, sample=NEQUIP_SAMPLE):
    """ogb_products: the pipeline's host seconds (``random_graph``,
    ``build_csr``, ``neighbor_sample``), then ``forward_energy`` at full
    size under ``no_grad``."""
    from repro_torch.data.pipelines import build_csr, neighbor_sample, random_graph

    free_device_memory()
    N, E = info["n_nodes"], info["n_edges"]
    t0 = time.perf_counter()
    g = random_graph(N, E, info["d_feat"], n_graphs=info["n_graphs"])
    out = {"graph_host_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    indptr, nbrs = build_csr(N, g["edge_index"])
    out["build_csr_s"] = time.perf_counter() - t0
    seeds = np.random.default_rng(0).choice(N, sample[0], replace=False)
    t0 = time.perf_counter()
    nodes, sub = neighbor_sample(indptr, nbrs, seeds, fanouts=sample[1])
    out["neighbor_sample_s"] = time.perf_counter() - t0
    out["sample_nodes"], out["sample_edges"] = len(nodes), int(sub.shape[1])
    del indptr, nbrs, nodes, sub
    log(f"[nequip] {NEQUIP_OGB} pipeline on the host: random_graph {out['graph_host_s']:.2f} s, "
        f"build_csr {out['build_csr_s']:.2f} s, neighbor_sample ({sample[0]} seeds, fanout "
        f"{'-'.join(map(str, sample[1]))}) {out['neighbor_sample_s']:.3f} s: "
        f"{out['sample_nodes']:,} nodes, {out['sample_edges']:,} edges")
    cfg = cfgmod.config(d_feat_in=info["d_feat"])
    b = {k: torch.as_tensor(v, device=dev) for k, v in g.items()}
    del g
    params = nq.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    free, _ = torch.cuda.mem_get_info()
    chunks = nequip_ogb_chunks(info, cfg, free)
    out.update(chunks=chunks, free_gib=free / 2**30)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        def forward():
            return nequip_energy(nq, cfg, params, b, info["n_graphs"], chunks)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = forward()
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_calls(forward, 1, warm=False)
    out["profile"] = {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                      "by_class_ms": device_ms_by_class(prof),
                      "top_ms": dict(sorted(prof["by_kernel_ms"].items(),
                                            key=lambda kv: -kv[1])[:6])}
    require(bool(torch.isfinite(e).all()) and tuple(e.shape) == (info["n_graphs"],),
            (NEQUIP_OGB, "energies", e))
    out["energy"] = e.tolist()
    out["roofline"] = nequip_roofline(NEQUIP_OGB)
    log(f"[nequip] {NEQUIP_OGB}: forward_energy at {N:,} nodes, {E:,} edges, "
        f"{info['d_feat']} features under no_grad in {chunks} edge chunks (chosen of "
        f"{NEQUIP_OGB_CHUNKS} for {out['free_gib']:.1f} GiB free): {out['forward_s']:.3f} s "
        f"(the first call), peak {out['peak_gib']:.2f} GiB, energy {out['energy']}; a second "
        f"call profiled: wall {prof['wall_ms']:.1f} ms, device {prof['device_ms'] or 0:.1f} ms ("
        + ", ".join(f"{k} {v:.1f}" for k, v in out["profile"]["by_class_ms"].items())
        + "); top kernels " + "; ".join(f"{k[:60]} {v:.1f}"
                                        for k, v in out["profile"]["top_ms"].items())
        + f"; the train step's one-card roofline: compute {out['roofline']['compute_s']:.3e} "
        f"s, memory {out['roofline']['memory_s']:.3e} s")
    del b, params, e
    free_device_memory()
    return out


def phase_nequip(dev, shapes=None, ogb=None, steps=NEQUIP_STEPS, cli_steps=NEQUIP_CLI_STEPS):
    """Phase 13: NequIP at full width (5 layers, 32 channels, l_max 2, 8
    radial functions, cutoff 5) on the registry's GNN shapes (``shapes``:
    shape -> its ``GNN_SHAPES`` entry, default ``NEQUIP_SHAPES``; ``ogb``
    the forward-only shape's entry, default ``NEQUIP_OGB``'s), then the
    training CLI.  No kernel of the port runs here."""
    from repro_torch.configs import nequip as cfgmod
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.models import nequip as nq

    t_phase = time.perf_counter()
    shapes = shapes or {s: GNN_SHAPES[s] for s in NEQUIP_SHAPES}
    runs = {"card": nvidia_smi_line(), "train": {}}
    for shape, info in shapes.items():
        runs["train"][shape] = nequip_train_shape(nq, cfgmod, dev, shape, info, steps)
    runs["ogb"] = nequip_ogb(nq, cfgmod, dev, ogb or GNN_SHAPES[NEQUIP_OGB])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "nequip", "--steps",
             str(cli_steps), "--ckpt", ckpt, *NEQUIP_CLI_ARGS],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300)
    require(res.returncode == 0, ("nequip training CLI", res.returncode, res.stderr[-2000:]))
    line = res.stdout.strip().splitlines()[-1]
    require(line.startswith(f"[nequip] steps={cli_steps} loss "), ("CLI output", line))
    runs["cli_s"] = time.perf_counter() - t0
    log(f"[nequip] python -m repro_torch.launch.train --arch nequip --steps {cli_steps} "
        f"{' '.join(NEQUIP_CLI_ARGS)}: exit 0 in {runs['cli_s']:.1f} s; {line}")
    runs["phase_s"] = time.perf_counter() - t_phase
    log(f"[nequip] phase body {runs['phase_s']:.1f} s; {nvidia_smi_line()}")
    return runs


# ---------------------------------------------------------------------------
# Phase 14: several ranks on one card
# ---------------------------------------------------------------------------

EP_LAYERS = 4                 # (a), (d): one group of Scout (3 local + 1 global)
EP_MESH = (1, 2)              # (a): data 1, model 2 on cuda:0 over gloo
EP_BATCH = (1, 4096)          # tokens a rank a step (its data shard of the batch)
EP_STEPS = 2                  # (a): the first untimed, the second with its collectives timed
EP_LOSS_RTOL = 2e-3           # (a), (d) bf16 loss against the local dispatch's
EP_F32_TOL = 1e-5             # (b): each gradient leaf, card against CPU, of its max |value|
EP_F32_BATCH = (4, 64)        # (b): the reduced Scout (local chunk 32), 2 sequences a data shard
NQ_PART_MESH = (2, 2)         # (c): 4 ranks on cuda:0 over gloo
NQ_PART_STEPS = 8
NQ_PART_GRAD_TOL = 1e-4       # (c): each summed gradient leaf, of its max |value|
PHASE14_AXES = ("data", "model")


def _sync(dev):
    """Wait for ``dev`` (a rank's device: the CPU in a rehearsal)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev, reset=False) -> float:
    if torch.device(dev).type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _with_segments(fn):
    """``fn()`` with the ranks' allocator growing segments in place: ranks
    that share one card keep the caching allocator from fragmenting it (the
    ranks' setting alone)."""
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        return fn()
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def ep_seeded_params(cfg, dev, seed, experts):
    """Llama 4 parameters whose every leaf, and every expert of an expert
    leaf, is drawn N(0, 0.02^2) from a seed of its own (norms are ones), so
    that a rank draws its ``experts`` alone and the whole tree drawn in one
    process holds the same numbers."""
    from repro_torch.dist.step import EXPERT_LEAVES
    from repro_torch.models.transformer import param_shapes
    from repro_torch.train.tree import flatten, unflatten

    shapes, paths = flatten(param_shapes(cfg))
    leaves = []
    for i, (shape, path) in enumerate(zip(shapes, paths)):
        if path[-1].endswith("norm"):
            leaves.append(torch.ones(shape, dtype=cfg.param_dtype, device=dev))
            continue
        blocks = [(g, e) for g in range(shape[0]) for e in experts] \
            if path[-1] in EXPERT_LEAVES else [None]
        t = torch.empty((shape[0], len(experts), *shape[2:]) if blocks[0] else shape,
                        dtype=cfg.param_dtype, device=dev)
        for b in blocks:
            gen = torch.Generator(device=dev)
            if b is None:
                gen.manual_seed(seed * 1_000_003 + i * 10_007)
                t.normal_(0.0, 0.02, generator=gen)
            else:
                g, e = b
                gen.manual_seed(seed * 1_000_003 + i * 10_007 + g * 101 + e + 1)
                t[g, list(experts).index(e)].normal_(0.0, 0.02, generator=gen)
        leaves.append(t)
    return unflatten(param_shapes(cfg), leaves)


def ep_tokens(cfg, dev, seed, shape):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)


def ep_rank_train(mesh, cfg, seed, batch, steps):
    """(a), (d) on one rank: its experts drawn, its data shard of the batch,
    ``steps`` expert-parallel loss-and-gradient steps (no optimizer step:
    see the phase).  The flash launches of all steps, each step's loss,
    seconds, peak memory, bytes this rank's collectives sent, their seconds
    where timed (host staging under gloo), the gradient's global norm."""
    import dataclasses

    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.dist.step import ep_param_specs, ep_value_and_grad, sharded_norm
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.train.tree import flatten

    dev = mesh.device
    cfg = dataclasses.replace(cfg, ep_mesh=mesh, ep_dp_axes=mesh.dp_axes)
    E, ep, m = cfg.moe.n_experts, mesh.group_size("model"), mesh.group_rank("model")
    t0 = time.perf_counter()
    params = ep_seeded_params(cfg, dev, seed, range(m * E // ep, (m + 1) * E // ep))
    tokens = ep_tokens(cfg, dev, seed, (batch[0] * mesh.group_size("data"), batch[1]))
    tokens = local_shard(tokens, P("data", None), mesh.shape, dict(zip(mesh.axis_names,
                                                                        mesh.coords)))
    _sync(dev)
    free = torch.cuda.mem_get_info(dev)[0] if torch.device(dev).type == "cuda" else 0
    out = {"rank": mesh.rank, "coords": mesh.coords, "backend": mesh.backend,
           "free_gib_after_init": free / 2**30,
           "experts": [m * E // ep, (m + 1) * E // ep], "init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size() for t in flatten(params)[0]),
           "tokens": tokens.numel(), "steps": []}
    fa.launches = fa.hopper_launches = 0  # the expert-parallel path's run starts here
    for step in range(steps):
        mesh.timed = step > 0
        mesh.reset_traffic()
        _peak_gib(dev, reset=True)
        _sync(dev)
        t0 = time.perf_counter()
        loss, grads = ep_value_and_grad(cfg, params, {"tokens": tokens, "labels": tokens})
        norm = sharded_norm(grads, ep_param_specs(params, mesh, cfg.ep_fsdp), mesh)
        finite = bool(torch.stack([torch.isfinite(g).all() for g in flatten(grads)[0]]).all())
        _sync(dev)
        dt = time.perf_counter() - t0
        out["steps"].append({"loss": float(loss), "s": dt, "grad_norm": float(norm),
                             "finite": finite, "peak_gib": _peak_gib(dev),
                             "bytes_sent": mesh.traffic["bytes"],
                             "collectives": mesh.traffic["calls"],
                             "staging_s": mesh.traffic["seconds"] if mesh.timed else None})
        out["grad_bytes"] = sum(g.numel() * g.element_size() for g in flatten(grads)[0])
        del grads
    out["launches"], out["hopper_launches"] = fa.launches, fa.hopper_launches
    return out


def ep_rank_f32(mesh, seed):
    """(b) on one rank: the reduced Scout in f32, ``ep_fsdp`` off and on,
    its loss and gradient blocks on the card and on the CPU (same ranks,
    same gloo groups)."""
    import dataclasses

    from repro_torch.configs import llama4_scout_17b_a16e as scout
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.dist.step import ep_param_specs, ep_value_and_grad, shard_tree
    from repro_torch.models.transformer import init_params
    from repro_torch.train.tree import flatten, map_leaves

    # the ranks share the host's cores for their CPU run
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // mesh.size))
    base = scout.reduced_config()
    full = init_params(base, torch.Generator().manual_seed(seed), "cpu")
    tokens = local_shard(ep_tokens(base, "cpu", seed, EP_F32_BATCH), P("data", None),
                         mesh.shape, dict(zip(mesh.axis_names, mesh.coords)))
    out = {}
    for fsdp in (False, True):
        cfg = dataclasses.replace(base, ep_mesh=mesh, ep_dp_axes=mesh.dp_axes, ep_fsdp=fsdp)
        mine = shard_tree(full, ep_param_specs(full, mesh, fsdp), mesh)
        for label, dev in (("card", mesh.device), ("cpu", torch.device("cpu"))):
            tok = tokens.to(dev)
            loss, grads = ep_value_and_grad(cfg, map_leaves(lambda t: t.to(dev), mine),
                                            {"tokens": tok, "labels": tok})
            out[(fsdp, label)] = {"loss": float(loss),
                                     "grads": [g.cpu() for g in flatten(grads)[0]]}
    return out


def nequip_rank_partitioned(mesh, info, steps):
    """(c) on one rank: ``minibatch_lg``'s graph (``random_graph``, seed 0,
    as phase 13's) partitioned by ``build_partition`` over the ranks, this
    rank's blocks on the card; the forward's collective bytes, the loss and
    summed gradient, then ``steps`` partitioned AdamW steps."""
    from repro_torch.configs import nequip as cfgmod
    from repro_torch.data.pipelines import random_graph
    from repro_torch.dist.roofline import gnn_bytes
    from repro_torch.dist.sharding import P, local_shard
    from repro_torch.dist.step import partitioned_train_step, partitioned_value_and_grad
    from repro_torch.models import nequip as nq
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.tree import flatten

    dev = mesh.device
    cfg = cfgmod.config(d_feat_in=info["d_feat"])
    t0 = time.perf_counter()
    g = random_graph(info["n_nodes"], info["n_edges"], info["d_feat"],
                     n_graphs=info["n_graphs"], seed=0)
    part = nq.build_partition(g["node_feat"], g["edge_index"], g["edge_vec"], g["graph_id"],
                              mesh.size)
    host_s = time.perf_counter() - t0
    spec = P(tuple(mesh.axis_names))
    coords = dict(zip(mesh.axis_names, mesh.coords))
    batch = {k: local_shard(torch.from_numpy(v), spec, mesh.shape, coords).to(dev)
             for k, v in part.items()}
    batch["energy"] = torch.as_tensor(g["energy"], device=dev)
    params = nq.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    loss_fn = nq.partitioned_train_step_fn(cfg, mesh, info["n_graphs"])
    xmax = part["export_idx"].shape[0] // mesh.size
    with torch.no_grad():
        mesh.reset_traffic()
        loss_fn(params, batch)
        fwd_bytes = mesh.traffic["bytes"]
    loss, grads = partitioned_value_and_grad(loss_fn, mesh, params, batch)
    opt = AdamWConfig()
    state = adamw_init(params, opt)
    step = partitioned_train_step(loss_fn, mesh, opt)
    whole = {k: torch.from_numpy(v) for k, v in part.items()}
    whole["energy"] = torch.as_tensor(g["energy"])
    formula = gnn_bytes(mesh, params, whole, {k: P() if k == "energy" else spec for k in whole})
    losses, seconds, sent = [], [], []
    for _ in range(steps):
        _sync(dev)
        mesh.reset_traffic()
        t0 = time.perf_counter()
        params, state, lo = step(params, state, batch)
        losses.append(float(lo))
        seconds.append(time.perf_counter() - t0)
        sent.append(mesh.traffic["bytes"])
    return {"loss": float(loss), "grads": [x.cpu() for x in flatten(grads)[0]],
            "losses": losses, "step_seconds": seconds, "host_partition_s": host_s,
            "step_bytes_sent": sent, "step_formula": formula,
            "nodes": batch["node_feat"].shape[0], "edges": batch["edge_src"].shape[0],
            "xmax": xmax, "forward_bytes_sent": fwd_bytes, "peak_gib": _peak_gib(dev)}


def square_rank(mesh, seed, info, steps):
    """(b) then (c) on one rank of the (2, 2) world: one spawn for both."""
    return {"f32": ep_rank_f32(mesh, seed), "nequip": nequip_rank_partitioned(mesh, info, steps)}


def phase_multirank(dev, fa, ep_cfg=None, steps=EP_STEPS, batch=EP_BATCH, nq_info=None,
                    nq_steps=NQ_PART_STEPS, d_backend="nccl", d_device="cuda:{rank}"):
    """Phase 14: several ranks on one card (``launch.mesh.spawn_ranks``).
    (a) Scout at full width (``ep_cfg``: default its config cut to
    ``EP_LAYERS``, flash attention, capacity factor E), one group, on a
    (data 1, model 2) mesh over gloo; (b) the reduced Scout in f32 on (2,
    2), card against CPU; (c) NequIP ``minibatch_lg`` (``nq_info``: a
    ``GNN_SHAPES`` entry) partitioned over 4 ranks against the dense
    one-card step; (d) (a)'s code on a 1-rank group of ``d_backend`` (NCCL;
    a rehearsal on the CPU passes gloo) on ``d_device``.  Returns the flash launches of (a) and (d) and the
    numbers.  On CPU tensors (a rehearsal) the flash wrapper runs its plain
    version and launches nothing, and the launch checks expect 0."""
    import dataclasses

    from repro_torch.configs import llama4_scout_17b_a16e as scout
    from repro_torch.configs import nequip as nq_cfgmod
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.dist.sharding import from_shards
    from repro_torch.dist.step import ep_param_specs
    from repro_torch.launch.mesh import Mesh, spawn_ranks
    from repro_torch.models import nequip as nq
    from repro_torch.models.transformer import forward_train
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.tree import flatten

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    runs = {"card": card}
    free_device_memory()

    # (a) Scout at full width, one group, 2 ranks of 8 experts on cuda:0 over gloo
    base = scout.config()
    if ep_cfg is None:
        ep_cfg = dataclasses.replace(base, n_layers=EP_LAYERS, attention_impl="flash")
    E = ep_cfg.moe.n_experts
    cfg = dataclasses.replace(ep_cfg, moe=dataclasses.replace(ep_cfg.moe,
                                                              capacity_factor=float(E)))
    per_step = 2 * cfg.n_layers if torch.device(dev).type == "cuda" else 0
    t0 = time.perf_counter()
    # two ranks of 33 GiB peaks share the card
    ranks = _with_segments(lambda: spawn_ranks(ep_rank_train, EP_MESH, "gloo", dev,
                                               args=(cfg, 0, batch, steps), axes=PHASE14_AXES))
    a_s = time.perf_counter() - t0
    n_ranks = len(ranks)
    for r in ranks:
        require((r["launches"], r["hopper_launches"]) == (per_step * steps,) * 2,
                ("ep flash launches (all, Hopper) a rank", r["rank"], r["launches"],
                 r["hopper_launches"], "steps", steps))
        require(all(s["finite"] for s in r["steps"]), ("ep gradients finite", r["rank"]))
    losses = [s["loss"] for s in ranks[0]["steps"]]
    require(all(s["loss"] == losses[i] for r in ranks for i, s in enumerate(r["steps"])),
            ("ep loss differs between ranks", [[s["loss"] for s in r["steps"]] for r in ranks]))
    last = [r["steps"][-1] for r in ranks]
    staging = max(s["staging_s"] for s in last)
    step_s = max(s["s"] for s in last)
    grad_gb = ranks[0]["grad_bytes"] / 1e9
    param_gb = ranks[0]["param_bytes"] / 1e9
    # functional AdamW: f32 moments (2 x 4 bytes a parameter) and a new copy
    # of the parameters, beside the parameters and the gradient
    n_params = ranks[0]["param_bytes"] // 2
    adamw_gb = n_ranks * (param_gb * 2 + grad_gb + n_params * 8 / 1e9)
    runs["ep"] = {"mesh": EP_MESH, "layers": cfg.n_layers, "tokens_a_rank": ranks[0]["tokens"],
                  "capacity_factor": float(E), "steps": [r["steps"] for r in ranks],
                  "init_s": [r["init_s"] for r in ranks], "phase_s": a_s,
                  "param_gb_a_rank": param_gb, "grad_gb_a_rank": grad_gb,
                  "adamw_gb_all_ranks": adamw_gb,
                  "launches_a_rank": [r["launches"] for r in ranks]}
    log(f"[multirank] (a) {cfg.name} at d_model {cfg.d_model}, {cfg.n_layers} layers, on a (data, model) = "
        f"{EP_MESH} mesh: {n_ranks} ranks on {dev} over gloo, experts {ranks[0]['experts']} "
        f"and {ranks[-1]['experts']}; {ranks[0]['tokens']:,} tokens a rank a step "
        f"(batch {batch}), capacity factor {E} (no drop); {param_gb:.2f} GB of bf16 weights "
        f"and {grad_gb:.2f} GB of gradients a rank; init {max(runs['ep']['init_s']):.1f} s; "
        f"card memory free after every rank's weights "
        f"{min(r['free_gib_after_init'] for r in ranks):.2f} GiB")
    for i in range(steps):
        st = [r["steps"][i] for r in ranks]
        log(f"[multirank] (a) step {i + 1}: loss {st[0]['loss']:.6f}, "
            f"{max(s['s'] for s in st):.3f} s, grad norm {st[0]['grad_norm']:.5g}, peak "
            + "/".join(f"{s['peak_gib']:.2f}" for s in st) + " GiB a rank, "
            + "/".join(f"{s['bytes_sent'] / 1e9:.3f}" for s in st) + " GB sent a rank in "
            f"{st[0]['collectives']} collectives"
            + (f", host staging {max(s['staging_s'] for s in st):.3f} s "
               f"({max(s['staging_s'] for s in st) / max(s['s'] for s in st):.1%} of the step)"
               if st[0]["staging_s"] is not None else " (collectives untimed)"))
    log(f"[multirank] (a) flash launches a rank over {steps} steps: "
        + ", ".join(f"{r['launches']} ({r['hopper_launches']} Hopper)" for r in ranks)
        + f" = {per_step} a step (forward + the checkpointed recompute)")
    runs["ep"]["adamw"] = (
        f"no AdamW step: with f32 moments it needs {adamw_gb:.1f} GB on the card for "
        f"{n_ranks} ranks (parameters {param_gb:.1f} GB, their new copy {param_gb:.1f} GB, "
        f"gradient {grad_gb:.1f} GB and moments {n_params * 8 / 1e9:.1f} GB a rank), more "
        "than its 80 GB" if adamw_gb > 80 else "AdamW fits but is not run")
    log(f"[multirank] (a) {runs['ep']['adamw']}")

    # the same weights and tokens through the local dispatch in one process
    free_device_memory()
    t0 = time.perf_counter()
    full = ep_seeded_params(cfg, dev, 0, range(E))
    tokens = ep_tokens(cfg, dev, 0, (batch[0] * EP_MESH[0], batch[1]))
    with torch.no_grad():
        local = float(forward_train(cfg, full, tokens, tokens))
    del full
    free_device_memory()
    rel = abs(losses[0] - local) / abs(local)
    require(rel <= EP_LOSS_RTOL, ("ep loss against the local dispatch", losses[0], local, rel))
    runs["ep"].update(local_loss=local, loss_rel=rel, local_s=time.perf_counter() - t0)
    log(f"[multirank] (a) loss {losses[0]:.6f} against the local dispatch's {local:.6f} on the "
        f"same weights and tokens in one process: {rel:.2e} relative (tolerance "
        f"{EP_LOSS_RTOL}); {runs['ep']['local_s']:.1f} s")

    # (d) the same code on a 1-rank NCCL group
    t0 = time.perf_counter()
    (nccl,) = spawn_ranks(ep_rank_train, (1, 1), d_backend, d_device, args=(cfg, 0, batch, 1),
                          axes=PHASE14_AXES)
    require((nccl["launches"], nccl["hopper_launches"]) == (per_step,) * 2,
            ("nccl flash launches", nccl["launches"], nccl["hopper_launches"]))
    require(nccl["steps"][0]["finite"], "nccl gradients finite")
    d_rel = abs(nccl["steps"][0]["loss"] - local) / abs(local)
    require(d_rel <= EP_LOSS_RTOL, ("nccl loss against the local dispatch", d_rel))
    runs["nccl"] = {"steps": nccl["steps"], "loss_rel": d_rel, "launches": nccl["launches"],
                    "phase_s": time.perf_counter() - t0}
    log(f"[multirank] (d) the same step on a 1-rank {d_backend} group ({E} experts, {cfg.n_layers} "
        f"layers): loss {nccl['steps'][0]['loss']:.6f} ({d_rel:.2e} from the local dispatch), "
        f"{nccl['steps'][0]['s']:.3f} s, peak {nccl['steps'][0]['peak_gib']:.2f} GiB, "
        f"{nccl['steps'][0]['collectives']} collectives, {nccl['launches']} flash launches "
        f"({nccl['hopper_launches']} Hopper); {runs['nccl']['phase_s']:.1f} s")

    # (b) the reduced Scout in f32 on (2, 2), the card against the CPU, and
    # (c) NequIP partitioned, in one world of 4 ranks on the card over gloo
    t0 = time.perf_counter()
    info = nq_info or GNN_SHAPES["minibatch_lg"]
    square = spawn_ranks(square_rank, NQ_PART_MESH, "gloo", dev, args=(0, info, nq_steps),
                         axes=PHASE14_AXES)
    square_s = time.perf_counter() - t0
    f32, parts = [r["f32"] for r in square], [r["nequip"] for r in square]
    mesh = Mesh(PHASE14_AXES, NQ_PART_MESH)
    like = scout.reduced_config()
    from repro_torch.models.transformer import param_shapes

    shapes = param_shapes(like)
    worst = {}
    for fsdp in (False, True):
        specs = flatten(ep_param_specs(shapes, mesh, fsdp))[0]
        got = [from_shards([r[(fsdp, "card")]["grads"][j] for r in f32], s, mesh)
               for j, s in enumerate(specs)]
        want = [from_shards([r[(fsdp, "cpu")]["grads"][j] for r in f32], s, mesh)
                for j, s in enumerate(specs)]
        errs = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(got, want)]
        worst[fsdp] = max(errs)
        require(worst[fsdp] <= EP_F32_TOL, ("f32 ep gradient, card against CPU", fsdp, errs))
        loss_rel = abs(f32[0][(fsdp, "card")]["loss"] - f32[0][(fsdp, "cpu")]["loss"])
        require(loss_rel <= EP_F32_TOL * abs(f32[0][(fsdp, "cpu")]["loss"]), ("f32 ep loss", fsdp))
    runs["ep_f32"] = {"worst_leaf_rel": {str(k): v for k, v in worst.items()}}
    log(f"[multirank] (b) {like.name} in f32 on (2, 2), 4 ranks on {dev} over gloo, batch "
        f"{EP_F32_BATCH}: every gradient leaf on the card against the same ranks on the CPU, "
        f"worst {worst[False]:.2e} (ep_fsdp off) and {worst[True]:.2e} (on) of the leaf's "
        f"max |value| (tolerance {EP_F32_TOL}); the world of (b) and (c) {square_s:.1f} s")

    # (c) NequIP minibatch_lg partitioned over 4 ranks against the dense
    # one-card step, both in f32, and the dense loss in f64 beside them
    t0 = time.perf_counter()
    ncfg = nq_cfgmod.config(d_feat_in=info["d_feat"])
    b, _ = nequip_graph(info, dev)
    params = nq.init_params(ncfg, torch.Generator(device=dev).manual_seed(0), dev)

    def dense_loss(p, bb):
        return nq.forward_train(ncfg, p, bb, info["n_graphs"], n_edge_chunks=info["edge_chunks"])

    loss, grads = value_and_grad(dense_loss, params, b)
    loss = float(loss)
    with torch.no_grad():
        loss64 = float(dense_loss(
            {k: ([{n: w.double() for n, w in lp.items()} for lp in v] if k == "layers"
                 else v.double()) for k, v in params.items()},
            {k: v.double() if v.is_floating_point() else v for k, v in b.items()}))
    loss_tol = 2 * nequip_energy_rtol(info)
    loss_rel = max(abs(r["loss"] - loss) for r in parts) / abs(loss)
    require(loss_rel <= loss_tol, ("partitioned loss against the dense", loss_rel, loss_tol))
    grad_err = max(float((g - w.cpu()).abs().max() / w.abs().max().clamp_min(1e-30))
                   for r in parts for g, w in zip(r["grads"], flatten(grads)[0]))
    require(grad_err <= NQ_PART_GRAD_TOL, ("partitioned gradient against the dense", grad_err))
    for r in parts:
        require(len(r["losses"]) == nq_steps and all(np.isfinite(r["losses"])),
                ("partitioned losses", r["losses"]))
    n, C, L = len(parts), ncfg.channels, ncfg.n_layers
    xmax = parts[0]["xmax"]
    formula = nq.halo_bytes_per_layer(n, xmax, C)
    # the forward's all-gathers (s alone on layer 0, then s, v, t: 13 floats a
    # channel) and the energies' all-reduce, as dist.collectives counts them
    sent = (n - 1) * xmax * C * 4 * (1 + 13 * (L - 1)) + int(4 * info["n_graphs"] * 2 * (n - 1) / n)
    med = float(np.median(parts[0]["step_seconds"][1:]))
    runs["nequip_partitioned"] = {
        "ranks": n, "loss": loss, "loss_rel": loss_rel, "grad_err": grad_err,
        "losses": parts[0]["losses"], "step_seconds": parts[0]["step_seconds"],
        "step_median_s": med, "xmax": xmax, "halo_bytes_per_layer": formula,
        "forward_bytes_sent_a_rank": [r["forward_bytes_sent"] for r in parts],
        "nodes_a_rank": parts[0]["nodes"], "edges_a_rank": parts[0]["edges"],
        "host_partition_s": parts[0]["host_partition_s"], "loss_f64": loss64,
        "part_f64_rel": abs(parts[0]["loss"] - loss64) / abs(loss64),
        "dense_f64_rel": abs(loss - loss64) / abs(loss64), "loss_tol": loss_tol,
        "peak_gib": [r["peak_gib"] for r in parts], "dense_s": time.perf_counter() - t0}
    require(all(r["forward_bytes_sent"] == sent for r in parts),
            ("halo bytes sent a rank", [r["forward_bytes_sent"] for r in parts], sent))
    step_formula = parts[0]["step_formula"]
    runs["nequip_partitioned"].update(step_bytes_sent_a_rank=[r["step_bytes_sent"] for r in parts],
                                      step_formula=step_formula)
    require(all(b == step_formula == r["step_formula"] for r in parts
                for b in r["step_bytes_sent"]),
            ("partitioned step bytes sent a rank against gnn_bytes",
             [r["step_bytes_sent"] for r in parts], step_formula))
    log(f"[multirank] (c) nequip ({info['n_nodes']:,} nodes, {info['n_edges']:,} edges, "
        f"{info['d_feat']} features) partitioned by build_partition over {n} ranks on {dev} "
        f"over gloo: {parts[0]['nodes']:,} nodes and {parts[0]['edges']:,} edge slots a rank, "
        f"{xmax:,} halo exports a rank (partition {parts[0]['host_partition_s']:.2f} s on the "
        f"host); loss {parts[0]['loss']:.6f} against the dense one-card step's {loss:.6f}: "
        f"{loss_rel:.2e} relative (tolerance {loss_tol:.2e}, phase 13's: twice the energies' "
        f"f32 summation bound); the dense loss in f64 {loss64:.6f}, from which the "
        f"partitioned one lies {runs['nequip_partitioned']['part_f64_rel']:.2e} and the dense "
        f"f32 one {runs['nequip_partitioned']['dense_f64_rel']:.2e}; summed gradient within "
        f"{grad_err:.2e} of each leaf's max (tolerance {NQ_PART_GRAD_TOL}); {nq_steps} AdamW "
        f"steps, losses " + " ".join(f"{x:.4g}" for x in parts[0]["losses"])
        + f"; median of steps 2-{nq_steps} {med:.4f} s; halo a layer after the first: "
        f"|halo| x C x 13 x 4 = {n} x {xmax:,} x {C} x 13 x 4 = {formula:,} bytes gathered "
        f"(the reference's formula), {sent:,} bytes sent a rank by the forward's collectives "
        f"over its {L} layers (layer 0 gathers s alone), {step_formula:,} by every rank in "
        f"each training step (gnn_bytes: the halo's gathers and their reduce-scatters, the "
        f"energies' and the gradient's sums); peak "
        + "/".join(f"{x:.2f}" for x in runs["nequip_partitioned"]["peak_gib"]) + " GiB a rank")
    del b, params, grads
    free_device_memory()
    runs["phase_s"] = time.perf_counter() - t_phase
    log(f"[multirank] phase body {runs['phase_s']:.1f} s; {nvidia_smi_line()}")
    launches = sum(r["launches"] for r in ranks) + nccl["launches"]
    return {"flash_attention": launches}, runs


# ---------------------------------------------------------------------------
# Phase 15: the registry's layout run as per-rank programs on one card
# ---------------------------------------------------------------------------

TP_ARCH = "llama3.2-3b"
TP_TRAIN_MESH = (2, 2)        # (a): data 2, model 2: 4 ranks on cuda:0 over gloo
TP_TRAIN_LAYERS = 4           # (a): of 28 (the phase's budget, with the f32 check's)
TP_TRAIN_BATCH = (1, 2048)    # (a): a data shard's rows and tokens a step
TP_TRAIN_STEPS = 2            # (a): the second with its collectives timed
TP_F32_BATCH = (1, 256)       # (a): the f32 gradient check's data shard
TP_F32_TOL = 1e-5             # (a): loss and each gradient leaf, of the one-rank max |value|
TP_SERVE_MESH = (1, 2)        # (b), (c): data 1, model 2
TP_PREFILL = (1, 4096)        # (b): prompt rows and tokens
TP_DECODE_STEPS = 8           # (b): greedy decode steps after the prefill
TP_SERVE_F32 = (4, 1024)      # (b): the f32 check's layers and prompt tokens
TP_SERVE_TOL = 1e-4           # (b): logits and cache, of the one-rank max |value|
TP_TABLE_CHUNK = 1 << 20      # (c): rows a seeded chunk of a big table
TP_RECSYS_REPS = {"serve_p99": 5, "serve_bulk": 0}   # (c): timed calls after the checked one


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _max_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def tp_rank_train(mesh, cfg, seed, batch, steps, f32_batch):
    """(a) on one rank: the registry's ``train_4k`` cell of the full config
    built on this rank mesh (its ``in_specs``: FSDP on), the rank's blocks of
    ``cfg``'s seeded weights (``cfg``: the config cut in depth, the cell's
    specs leaf for leaf) and zero moments, ``steps`` ZeRO-1 steps, then the
    f32 loss and gradient against the one-rank ``forward_train`` on this
    card (TF32 off)."""
    import dataclasses

    from repro_torch.configs.registry import build_cell
    from repro_torch.dist.roofline import tp_train_bytes
    from repro_torch.dist.sharding import P, local_shard, spec_axes
    from repro_torch.dist.step import shard_tree, tp_train_step, tp_value_and_grad
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.transformer import forward_train, init_params
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import AdamWConfig, opt_state_shapes
    from repro_torch.train.tree import flatten, map_leaves

    dev = mesh.device
    cell = build_cell(TP_ARCH, "train_4k", mesh=mesh)
    pspecs, ospecs = cell.in_specs[0], cell.in_specs[1]
    coords = dict(zip(mesh.axis_names, mesh.coords))
    dp = mesh.group_size("data")
    t0 = time.perf_counter()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    params = shard_tree(full, pspecs, mesh)
    del full
    abstract = init_params(cfg, None, "meta")
    want_shapes = [tuple(local_shard(t, s, mesh.shape, coords).shape)
                   for t, s in zip(flatten(abstract)[0], flatten(pspecs)[0])]
    opt_cfg = AdamWConfig()
    opt = map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                     shard_tree(opt_state_shapes(abstract, opt_cfg), ospecs, mesh))
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    tokens = torch.randint(0, cfg.vocab, (batch[0] * dp, batch[1]), generator=gen, device=dev)
    tok = local_shard(tokens, P(mesh.dp_axes, None), mesh.shape, coords)
    step = tp_train_step(cfg, opt_cfg, mesh, pspecs, ospecs["m"])
    _sync(dev)
    out = {"rank": mesh.rank, "coords": mesh.coords, "init_s": time.perf_counter() - t0,
           "fsdp": sorted({str(spec_axes(s)) for s in flatten(pspecs)[0]
                           if set(spec_axes(s)) & set(mesh.dp_axes)}),
           "param_bytes": sum(t.numel() * t.element_size() for t in flatten(params)[0]),
           "moment_bytes": sum(t.numel() * t.element_size() for t in flatten(opt)[0]),
           "tokens": tok.numel(), "steps": [],
           "formula_bytes": tp_train_bytes(cfg, mesh, pspecs, ospecs["m"], tuple(tok.shape))}
    fa.launches = fa.hopper_launches = 0  # the layout's training path starts here
    for s in range(steps):
        mesh.timed = s > 0
        mesh.reset_traffic()
        _peak_gib(dev, reset=True)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, {"tokens": tok, "labels": tok})
        loss = float(loss)
        _sync(dev)
        dt = time.perf_counter() - t0
        out["steps"].append({
            "loss": loss, "s": dt, "peak_gib": _peak_gib(dev),
            "bytes_sent": mesh.traffic["bytes"], "collectives": mesh.traffic["calls"],
            "staging_s": mesh.traffic["seconds"] if mesh.timed else None,
            "shapes_ok": [tuple(x.shape) for x in flatten(params)[0]] == want_shapes,
            "finite": bool(torch.stack([torch.isfinite(x.float()).all()
                                        for x in flatten(params)[0]]).all())})
    out["launches"], out["hopper_launches"] = fa.launches, fa.hopper_launches
    mesh.timed = False
    del params, opt
    # the f32 check: the same layers, TF32 off, against the one-rank step
    t_f32 = time.perf_counter()
    _tf32_off()
    c32 = dataclasses.replace(cfg, param_dtype=torch.float32, act_dtype=torch.float32)
    full = init_params(c32, torch.Generator(device=dev).manual_seed(seed + 1), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    tokens = torch.randint(0, cfg.vocab, (f32_batch[0] * dp, f32_batch[1]), generator=gen,
                           device=dev)
    tok = local_shard(tokens, P(mesh.dp_axes, None), mesh.shape, coords)
    loss, grads = tp_value_and_grad(c32, mesh, pspecs, ospecs["m"], shard_tree(full, pspecs, mesh),
                                    {"tokens": tok, "labels": tok})
    one_loss, one = value_and_grad(lambda p, b: forward_train(c32, p, b, b), full, tokens)
    del full
    errs = [_max_rel(g, local_shard(w, s, mesh.shape, coords))
            for g, w, s in zip(flatten(grads)[0], flatten(one)[0], flatten(ospecs["m"])[0])]
    out["f32"] = {"loss": float(loss), "one_rank_loss": float(one_loss),
                  "loss_rel": abs(float(loss) - float(one_loss)) / abs(float(one_loss)),
                  "worst_leaf_rel": max(errs), "s": time.perf_counter() - t_f32}
    return out


def tp_rank_serve(mesh, cfg, seed, prompt, decode_steps, f32):
    """(b) on one rank: the registry's ``prefill_32k`` cell of the full
    config on this rank mesh (its ``in_specs``), a prefill of ``prompt`` and
    ``decode_steps`` greedy decode steps (the argmax over the gathered
    vocab), then an f32 prefill and decode step at ``f32`` = (layers,
    tokens) against the one-rank ones on this card."""
    import dataclasses

    from repro_torch.configs.registry import build_cell
    from repro_torch.dist.collectives import gather_
    from repro_torch.dist.roofline import tp_decode_bytes, tp_prefill_bytes
    from repro_torch.dist.sharding import P, lm_cache_specs, axes_for_mesh, local_shard
    from repro_torch.dist.step import shard_tree
    from repro_torch.dist.tp import Layout
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.transformer import forward_decode, forward_prefill, init_params
    from repro_torch.train.tree import flatten

    dev = mesh.device
    cell = build_cell(TP_ARCH, "prefill_32k", mesh=mesh)
    pspecs = cell.in_specs[0]
    coords = dict(zip(mesh.axis_names, mesh.coords))
    dp = mesh.group_size("data")
    t0 = time.perf_counter()
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    params = shard_tree(full, pspecs, mesh)
    del full
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    tokens = torch.randint(0, cfg.vocab, (prompt[0] * dp, prompt[1]), generator=gen, device=dev)
    tok = local_shard(tokens, cell.in_specs[1], mesh.shape, coords)
    S = tok.shape[1]
    _sync(dev)
    out = {"rank": mesh.rank, "init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size() for t in flatten(params)[0])}
    with torch.no_grad():
        fa.launches = fa.hopper_launches = 0  # the layout's prefill starts here
        mesh.reset_traffic()
        _peak_gib(dev, reset=True)
        t0 = time.perf_counter()
        lay = Layout(cfg, mesh, pspecs, params)
        logits, cache = forward_prefill(cfg, params, tok, max_seq=S + decode_steps, layout=lay)
        _sync(dev)
        out.update(prefill_s=time.perf_counter() - t0, prefill_bytes=mesh.traffic["bytes"],
                   prefill_formula=tp_prefill_bytes(cfg, mesh, pspecs, tuple(tok.shape)),
                   decode_formula=tp_decode_bytes(cfg, mesh, pspecs, tok.shape[0]),
                   prefill_launches=fa.launches, prefill_hopper=fa.hopper_launches,
                   logits_shape=tuple(logits.shape),
                   cache_bytes=sum(c.numel() * c.element_size() for c in flatten(cache)[0]))
        fa.launches = fa.hopper_launches = 0  # decode: none expected
        seconds, picked, sent = [], [], []
        nxt = gather_(logits, mesh, "model", 1).argmax(-1)
        for k in range(decode_steps):
            _sync(dev)
            mesh.reset_traffic()
            t0 = time.perf_counter()
            logits, cache = forward_decode(cfg, params, nxt, cache, S + k, layout=lay)
            sent.append(mesh.traffic["bytes"])  # the step's, not the argmax's gather
            nxt = gather_(logits, mesh, "model", 1).argmax(-1)
            picked.append(nxt.tolist())
            seconds.append(time.perf_counter() - t0)
        out.update(decode_s=seconds, decode_bytes=sent, decode_launches=fa.launches,
                   picked=picked,
                   peak_gib=_peak_gib(dev), finite=bool(torch.isfinite(logits.float()).all()))
    del params, cache
    # the f32 check at f32[0] layers, TF32 off
    t_f32 = time.perf_counter()
    _tf32_off()
    c32 = dataclasses.replace(cfg, n_layers=f32[0], param_dtype=torch.float32,
                              act_dtype=torch.float32)
    full = init_params(c32, torch.Generator(device=dev).manual_seed(seed + 2), dev)
    toks = tokens[:, :f32[1]].contiguous()
    tok = local_shard(toks, cell.in_specs[1], mesh.shape, coords)
    with torch.no_grad():
        blocks = shard_tree(full, pspecs, mesh)
        lay = Layout(c32, mesh, pspecs, blocks)
        lg, cache = forward_prefill(c32, blocks, tok, max_seq=f32[1] + 1, layout=lay)
        d_lg, cache = forward_decode(c32, blocks, tok[:, 0], cache, f32[1], layout=lay)
        one_lg, one_cache = forward_prefill(c32, full, toks, max_seq=f32[1] + 1)
        one_d, one_cache = forward_decode(c32, full, toks[:, 0], one_cache, f32[1])
    axes = axes_for_mesh(mesh)
    lspec = P(mesh.dp_axes if toks.shape[0] % dp == 0 else None, mesh.model_axis)
    cspecs = lm_cache_specs(c32, axes, toks.shape[0], mesh)
    out["f32"] = {
        "logits_rel": max(_max_rel(lg, local_shard(one_lg, lspec, mesh.shape, coords)),
                          _max_rel(d_lg, local_shard(one_d, lspec, mesh.shape, coords))),
        "cache_rel": max(_max_rel(c, local_shard(w, s, mesh.shape, coords)) for c, w, s in
                         zip(flatten(cache)[0], flatten(one_cache)[0], flatten(cspecs)[0])),
        "s": time.perf_counter() - t_f32}
    return out


def rowwise_params(R, init, cfg, seed, dev, block=None):
    """The registry's serving copy of a recsys model (big tables bf16, the
    rest f32), drawn so that a rank draws its rows alone: each big table in
    chunks of ``TP_TABLE_CHUNK`` rows, each from a seed of its own, N(0,
    0.01^2); every other 2-D leaf N(0, 1/rows) from its own seed; vectors
    ones (``ln*``) or zeros.  ``block(path, rows) -> (lo, hi)``: the rows of
    a big table to draw (default all)."""
    from repro_torch.train.tree import flatten, unflatten

    like = init(cfg, None, device="meta")
    shapes, paths = flatten(like)
    leaves = []
    for i, (ab, path) in enumerate(zip(shapes, paths)):
        gen = torch.Generator(device=dev)
        if ab.dim() == 2 and ab.shape[0] >= R.LARGE_TABLE_ROWS:
            lo, hi = block(path, ab.shape[0]) if block else (0, ab.shape[0])
            t = torch.empty((hi - lo, ab.shape[1]), dtype=torch.bfloat16, device=dev)
            for c in range(lo // TP_TABLE_CHUNK, -(-hi // TP_TABLE_CHUNK)):
                c0, c1 = c * TP_TABLE_CHUNK, min((c + 1) * TP_TABLE_CHUNK, ab.shape[0])
                gen.manual_seed(seed * 1_000_003 + i * 10_007 + c)
                chunk = torch.empty((c1 - c0, ab.shape[1]), dtype=torch.bfloat16, device=dev)
                chunk.normal_(0.0, 0.01, generator=gen)
                a, b = max(lo, c0), min(hi, c1)
                t[a - lo:b - lo] = chunk[a - c0:b - c0]
        elif ab.dim() == 2:
            gen.manual_seed(seed * 1_000_003 + i * 10_007)
            t = torch.empty(tuple(ab.shape), dtype=torch.float32, device=dev)
            t.normal_(0.0, ab.shape[0] ** -0.5, generator=gen)
        else:
            fill = 1.0 if str(path[-1]).startswith("ln") else 0.0
            t = torch.full(tuple(ab.shape), fill, dtype=torch.float32, device=dev)
        leaves.append(t)
    return unflatten(like, leaves)


def tp_rank_recsys(mesh, configs, serve, want, batches, seed):
    """(c) on one rank: each model's ``serve_*`` cells of the registry on
    this rank mesh (big tables row-sharded over ``model``), the rank's rows
    drawn alone, the batches of the ``.npz`` at ``batches`` scored through
    the cell's step and held to the one-rank scores ``want`` bit for bit;
    embedding-bag launches and bytes sent a call, the first call's ms and
    the median of ``TP_RECSYS_REPS`` more."""
    from repro_torch.configs.registry import RECSYS, build_cell, get_arch_module
    from repro_torch.dist.roofline import recsys_bytes
    from repro_torch.dist.sharding import local_shard, spec_dims
    from repro_torch.kernels.embedding_bag import embedding_bag as eb
    from repro_torch.models import recsys as R
    from repro_torch.train.tree import flatten

    dev = mesh.device
    cuda = torch.device(dev).type == "cuda"
    data = np.load(batches)
    out = {"rank": mesh.rank}
    eb.launches = 0  # the row-sharded serving path starts here
    for arch, cfg in configs.items():
        free_device_memory()
        mod = get_arch_module(arch)
        published, mod.config = mod.config, lambda cfg=cfg: cfg  # the cells of ``cfg``
        try:
            cells = {shape: build_cell(arch, shape, mesh=mesh) for shape in serve}
        finally:
            mod.config = published
        leaves, paths = flatten(cells[next(iter(serve))].in_specs[0])
        specs = dict(zip(paths, leaves))
        tp, r = mesh.group_size("model"), mesh.group_rank("model")

        def block(path, rows, specs=specs):
            if spec_dims(specs[path], 2, mesh)[0] != 0:
                return 0, rows
            return r * rows // tp, (r + 1) * rows // tp

        t0 = time.perf_counter()
        params = rowwise_params(R, RECSYS[arch][0], cfg, seed, dev, block)
        _sync(dev)
        res = {"init_s": time.perf_counter() - t0,
               "param_bytes": sum(t.numel() * t.element_size() for t in flatten(params)[0]),
               "sharded": sorted("/".join(map(str, p)) for p, s in specs.items()
                                 if spec_dims(s, 2, mesh)[0] == 0)}
        coords = dict(zip(mesh.axis_names, mesh.coords))
        for shape in serve:
            cell = cells[shape]
            keys = [k[0] for k in flatten(cell.abstract_args[1])[1]]
            batch = {k: local_shard(torch.from_numpy(data[f"{arch}/{shape}/{k}"]).to(dev), s,
                                    mesh.shape, coords)
                     for k, s in zip(keys, flatten(cell.in_specs[1])[0])}
            mesh.reset_traffic()
            with torch.no_grad():
                before = eb.launches
                _sync(dev)
                t0 = time.perf_counter()
                got = cell.step_fn(params, batch)
                _sync(dev)
                first = (time.perf_counter() - t0) * 1e3
                launches, sent = eb.launches - before, mesh.traffic["bytes"]
                reps = TP_RECSYS_REPS[shape] if cuda else 0
                ms, again = (timed_calls(lambda: cell.step_fn(params, batch), reps) if reps
                             else (first, got))
            w = local_shard(want[arch][shape].to(dev), cell.out_specs, mesh.shape, coords)
            formula = recsys_bytes("serve", cfg, mesh, cell.abstract_args[0], cell.in_specs[0],
                                   flatten(batch)[0][0].shape[0])
            res[shape] = {"launches": launches, "first_ms": first, "ms": ms, "bytes_sent": sent,
                          "formula": formula,
                          "same_bits": bool(torch.equal(got, w) and torch.equal(again, w)),
                          "rows": int(got.shape[0])}
        out[arch] = res
        del params
    out["launches"] = eb.launches
    out["peak_gib"] = _peak_gib(dev)
    return out


def tp_rank_serving(mesh, serve_args, recsys_args):
    """(b), then (c) when ``recsys_args`` is given, on one rank of the
    (data 1, model 2) world: one spawn for both."""
    out = {"serve": tp_rank_serve(mesh, *serve_args)}
    if recsys_args is not None:
        free_device_memory()
        out["recsys"] = tp_rank_recsys(mesh, *recsys_args)
    return out


def phase_tp(dev, fa, eb, train_cfg=None, serve_cfg=None, train_batch=TP_TRAIN_BATCH,
             steps=TP_TRAIN_STEPS, f32_batch=TP_F32_BATCH, prompt=TP_PREFILL,
             decode_steps=TP_DECODE_STEPS, serve_f32=TP_SERVE_F32, recsys=None,
             serve=RECSYS_SERVE):
    """Phase 15: the registry's layout of the dense LM weights (``dist.tp``)
    and of the recsys tables, run as per-rank programs on one card over gloo.
    (a) llama3.2-3b at full width (``train_cfg``: default cut to
    ``TP_TRAIN_LAYERS``, flash attention) on (data 2, model 2) in the
    ``train_4k`` cell's layout: ZeRO-1 steps, then an f32 check; (b) its
    full depth (``serve_cfg``) on (data 1, model 2): prefill and greedy
    decode, then an f32 check; (c) the recsys models' row-sharded serving
    (``recsys``: arch -> config, default the published ones; ``False``
    skips it) at ``serve``'s batches, against one-rank scores.  Returns the launches of (a) and (b)'s paths and of (c)'s, and the
    numbers.  On CPU tensors (a rehearsal) the kernels' launch checks expect
    0."""
    import dataclasses

    from repro_torch.configs import llama3_2_3b
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.train.tree import flatten

    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    runs = {"card": nvidia_smi_line()}
    free_device_memory()

    # (a) training in the train_4k cell's layout on 4 ranks
    base = llama3_2_3b.config()
    cfg = train_cfg or dataclasses.replace(base, n_layers=TP_TRAIN_LAYERS, attention_impl="flash")
    per_step = 2 * cfg.n_layers if cuda else 0
    t0 = time.perf_counter()
    ranks = _with_segments(lambda: spawn_ranks(
        tp_rank_train, TP_TRAIN_MESH, "gloo", dev, args=(cfg, 0, train_batch, steps, f32_batch),
        axes=PHASE14_AXES))
    a_s = time.perf_counter() - t0
    for r in ranks:
        require(r["fsdp"], ("the train_4k cell's specs put no leaf over the data axes", r["rank"]))
        require((r["launches"], r["hopper_launches"]) == (per_step * steps,) * 2,
                ("tp flash launches (all, Hopper) a rank", r["rank"], r["launches"],
                 r["hopper_launches"], "steps", steps))
        require(all(s["shapes_ok"] and s["finite"] for s in r["steps"]),
                ("tp blocks of the cell's in_specs, finite", r["rank"]))
        require(all(s["bytes_sent"] == r["formula_bytes"] for s in r["steps"]),
                ("tp bytes sent against tp_train_bytes", r["rank"],
                 [s["bytes_sent"] for s in r["steps"]], r["formula_bytes"]))
        require(r["f32"]["loss_rel"] <= TP_F32_TOL and r["f32"]["worst_leaf_rel"] <= TP_F32_TOL,
                ("tp f32 loss and gradient against the one-rank step", r["rank"], r["f32"]))
    losses = [s["loss"] for s in ranks[0]["steps"]]
    require(all([s["loss"] for s in r["steps"]] == losses for r in ranks),
            ("tp loss differs between ranks", [[s["loss"] for s in r["steps"]] for r in ranks]))
    last = [r["steps"][-1] for r in ranks]
    step_s = max(s["s"] for s in last)
    staging = max(s["staging_s"] for s in last)
    runs["train"] = {
        "mesh": TP_TRAIN_MESH, "layers": cfg.n_layers, "tokens_a_rank": ranks[0]["tokens"],
        "steps": [r["steps"] for r in ranks], "step_s": step_s, "staging_s": staging,
        "staging_share": staging / step_s, "bytes_a_rank": last[0]["bytes_sent"],
        "formula_bytes": ranks[0]["formula_bytes"],
        "peak_gib_a_rank": [s["peak_gib"] for s in last],
        "param_gb_a_rank": ranks[0]["param_bytes"] / 1e9,
        "moment_gb_a_rank": ranks[0]["moment_bytes"] / 1e9,
        "fsdp_axes": ranks[0]["fsdp"], "f32": [r["f32"] for r in ranks], "phase_s": a_s,
        "launches_a_rank": [r["launches"] for r in ranks]}
    log(f"[tp] (a) {cfg.name} at d_model {cfg.d_model}, {cfg.n_layers} of {base.n_layers} "
        f"layers, bf16, in the train_4k cell's layout (FSDP on: leaves over "
        f"{', '.join(ranks[0]['fsdp'])}) on a (data, model) = {TP_TRAIN_MESH} mesh: "
        f"{len(ranks)} ranks on {dev} over gloo; {ranks[0]['tokens']:,} tokens a rank a step; "
        f"{ranks[0]['param_bytes'] / 1e9:.3f} GB of weights and "
        f"{ranks[0]['moment_bytes'] / 1e9:.3f} GB of moments a rank; init "
        f"{max(r['init_s'] for r in ranks):.1f} s")
    for i in range(steps):
        st = [r["steps"][i] for r in ranks]
        log(f"[tp] (a) step {i + 1}: loss {st[0]['loss']:.6f} on every rank, "
            f"{max(s['s'] for s in st):.3f} s, peak "
            + "/".join(f"{s['peak_gib']:.2f}" for s in st) + " GiB a rank, "
            f"{st[0]['bytes_sent']:,} bytes sent a rank in {st[0]['collectives']} collectives "
            f"(tp_train_bytes: {ranks[0]['formula_bytes']:,})"
            + (f", host staging {max(s['staging_s'] for s in st):.3f} s "
               f"({max(s['staging_s'] for s in st) / max(s['s'] for s in st):.1%} of the step)"
               if st[0]["staging_s"] is not None else " (collectives untimed)"))
    log(f"[tp] (a) flash launches a rank over {steps} steps: "
        + ", ".join(f"{r['launches']} ({r['hopper_launches']} Hopper)" for r in ranks)
        + f" = {per_step} a step; f32 at {f32_batch} a shard, TF32 off: loss "
        f"{max(r['f32']['loss_rel'] for r in ranks):.2e} from the one-rank forward_train's, "
        f"gradient leaves within {max(r['f32']['worst_leaf_rel'] for r in ranks):.2e} of "
        f"their max (tolerance {TP_F32_TOL}); {a_s:.1f} s")

    # (c)'s one-rank scores first (DLRM's 48 GB table whole on the card), its
    # batches to a file the ranks read
    tmp = tempfile.TemporaryDirectory()
    recsys_args = None
    if recsys is not False:
        from repro_torch.configs.registry import RECSYS, get_arch_module
        from repro_torch.models import recsys as R

        configs = recsys or {a: get_arch_module(a).config() for a in RECSYS_ARCHS}
        t0 = time.perf_counter()
        want, one, arrays = {}, {}, {}
        for arch, cfg in configs.items():
            free_device_memory()
            params = rowwise_params(R, RECSYS[arch][0], cfg, 0, dev)
            want[arch] = {}
            for shape, B in serve.items():
                b = recsys_batch(arch, cfg, B, seed=1)
                arrays.update({f"{arch}/{shape}/{k}": v for k, v in b.items()})
                b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                with torch.no_grad():
                    want[arch][shape] = recsys_score(R, arch, cfg, params, b).cpu()
            one[arch] = sum(t.numel() * t.element_size() for t in flatten(params)[0])
            del params, b
        free_device_memory()
        path = os.path.join(tmp.name, "batches.npz")
        np.savez(path, **arrays)
        one_s = time.perf_counter() - t0
        recsys_args = (configs, serve, want, path, 0)

    # (b) prefill and greedy decode at full depth, then (c), on 2 ranks
    cfg = serve_cfg or dataclasses.replace(base, attention_impl="flash")
    t0 = time.perf_counter()
    with tmp:
        both = _with_segments(lambda: spawn_ranks(
            tp_rank_serving, TP_SERVE_MESH, "gloo", dev,
            args=((cfg, 0, prompt, decode_steps, serve_f32), recsys_args), axes=PHASE14_AXES))
    bc_s = time.perf_counter() - t0
    ranks = [r["serve"] for r in both]
    per_prefill = cfg.n_layers if cuda else 0
    for r in ranks:
        require((r["prefill_launches"], r["prefill_hopper"]) == (per_prefill,) * 2,
                ("tp prefill flash launches a rank", r["rank"], r["prefill_launches"],
                 r["prefill_hopper"]))
        require(r["decode_launches"] == 0, ("tp decode flash launches", r["decode_launches"]))
        require(r["prefill_bytes"] == r["prefill_formula"],
                ("tp prefill bytes sent against tp_prefill_bytes", r["rank"], r["prefill_bytes"],
                 r["prefill_formula"]))
        require(all(b == r["decode_formula"] for b in r["decode_bytes"]),
                ("tp decode bytes sent against tp_decode_bytes", r["rank"], r["decode_bytes"],
                 r["decode_formula"]))
        require(r["finite"] and r["picked"] == ranks[0]["picked"],
                ("tp decode: finite, the same tokens on every rank", r["rank"]))
        require(r["f32"]["logits_rel"] <= TP_SERVE_TOL and r["f32"]["cache_rel"] <= TP_SERVE_TOL,
                ("tp f32 prefill/decode against the one-rank ones", r["rank"], r["f32"]))
    dec = [float(np.median(r["decode_s"][1:])) for r in ranks]
    runs["serve"] = {"mesh": TP_SERVE_MESH, "layers": cfg.n_layers, "prompt": prompt,
                     "prefill_s": max(r["prefill_s"] for r in ranks),
                     "prefill_bytes_a_rank": ranks[0]["prefill_bytes"],
                     "prefill_formula": ranks[0]["prefill_formula"],
                     "decode_bytes_a_rank": [r["decode_bytes"] for r in ranks],
                     "decode_formula": ranks[0]["decode_formula"],
                     "decode_s": [r["decode_s"] for r in ranks], "decode_median_s": max(dec),
                     "peak_gib_a_rank": [r["peak_gib"] for r in ranks],
                     "param_gb_a_rank": ranks[0]["param_bytes"] / 1e9,
                     "cache_gb_a_rank": ranks[0]["cache_bytes"] / 1e9,
                     "f32": [r["f32"] for r in ranks], "world_s": bc_s,
                     "launches_a_rank": [r["prefill_launches"] for r in ranks]}
    log(f"[tp] (b) {cfg.name}, {cfg.n_layers} layers, bf16, in the prefill_32k cell's layout on "
        f"(data, model) = {TP_SERVE_MESH}: {ranks[0]['param_bytes'] / 1e9:.3f} GB of weights a "
        f"rank; prefill {prompt[0]} x {prompt[1]:,} in "
        f"{runs['serve']['prefill_s']:.3f} s ({ranks[0]['prefill_bytes']:,} bytes sent a rank, "
        f"tp_prefill_bytes {ranks[0]['prefill_formula']:,}; each decode step "
        f"{ranks[0]['decode_bytes'][0]:,}, tp_decode_bytes {ranks[0]['decode_formula']:,}), "
        f"logits block {ranks[0]['logits_shape']}, {per_prefill} flash launches a rank (all "
        f"Hopper); {decode_steps} greedy decode steps, median {max(dec) * 1e3:.2f} ms, no flash "
        f"launch; peak " + "/".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB a rank; "
        f"f32 at {serve_f32[0]} layers and {serve_f32[1]} tokens: logits within "
        f"{max(r['f32']['logits_rel'] for r in ranks):.2e}, cache within "
        f"{max(r['f32']['cache_rel'] for r in ranks):.2e} of the one-rank ones (tolerance "
        f"{TP_SERVE_TOL})")
    launches = {"flash_attention": sum(runs["train"]["launches_a_rank"])
                + sum(runs["serve"]["launches_a_rank"])}

    if recsys_args is not None:
        ranks = [r["recsys"] for r in both]
        for r in ranks:
            for arch in configs:
                require(r[arch]["sharded"], (arch, "no table row-sharded"))
                for shape in serve:
                    got = r[arch][shape]
                    lookups = RECSYS_LOOKUPS[(arch, "score")] if cuda else 0
                    require(got["same_bits"], (arch, shape, "row-sharded scores differ from the "
                                               "one-rank ones", r["rank"]))
                    require(got["launches"] == lookups,
                            (arch, shape, "embedding-bag launches a call a rank", got["launches"]))
                    require(got["bytes_sent"] == got["formula"],
                            (arch, shape, "bytes sent a call a rank against recsys_bytes",
                             r["rank"], got["bytes_sent"], got["formula"]))
        runs["recsys"] = {"mesh": TP_SERVE_MESH, "one_rank_s": one_s,
                          "one_rank_gb": {a: v / 1e9 for a, v in one.items()},
                          "ranks": ranks}
        for arch in configs:
            r0 = ranks[0][arch]
            log(f"[tp] (c) {arch}: {one[arch] / 1e9:.3f} GB one rank, "
                + "/".join(f"{r[arch]['param_bytes'] / 1e9:.3f}" for r in ranks)
                + f" GB a rank on (data, model) = {TP_SERVE_MESH} (row-sharded: "
                f"{', '.join(r0['sharded'])}); "
                + "; ".join(f"{shape} B={B:,}: {max(r[arch][shape]['ms'] for r in ranks):.3f} ms a "
                            f"call (first {max(r[arch][shape]['first_ms'] for r in ranks):.3f}), "
                            f"{r0[shape]['bytes_sent']:,} bytes sent a rank (recsys_bytes "
                            f"{r0[shape]['formula']:,}), "
                            f"{r0[shape]['launches']} embedding-bag launches a rank, scores bit "
                            f"for bit the one-rank ones" for shape, B in serve.items()))
        log(f"[tp] (c) one-rank scores and batches {one_s:.1f} s; peak "
            + "/".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB a rank")
        launches["embedding_bag"] = sum(r["launches"] for r in ranks)
    log(f"[tp] (b) and (c) on {TP_SERVE_MESH}: {bc_s:.1f} s")

    runs["phase_s"] = time.perf_counter() - t_phase
    log(f"[tp] phase body {runs['phase_s']:.1f} s; {nvidia_smi_line()}")
    return launches, runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    from repro_torch.configs import llama3_2_3b, llama4_scout_17b_a16e, smollm_135m
    from repro_torch.kernels.backward_search import backward_search
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ilcp_list import ilcp_list
    from repro_torch.kernels.pdl_gather import pdl_gather
    from repro_torch.kernels.rank import rank
    from repro_torch.kernels.rmq import rmq
    from repro_torch.kernels.sada_c_list import sada_c_list
    from repro_torch.kernels.wt_list import wt_list

    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    build = phase_build()
    paths = {}
    t0 = time.perf_counter()
    svc, full_batches, paths["list"], full_data = phase_full_path(dev, backward_search,
                                                                  ilcp_list, pdl_gather)
    log(f"[full] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["topk_tfidf"], topk = phase_topk_tfidf(
        dev, (backward_search, ilcp_list, rank, rmq, pdl_gather))
    log(f"[topk] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    large = phase_large(dev, backward_search, ilcp_list)
    log(f"[large] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["primitives"], wm_args = phase_primitives(large, (rank, rmq))
    log(f"[prims] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lat = load_latency_ns(dev)
    records = kernel_checks(svc, full_batches, large, lat)
    records += primitive_kernel_checks(svc, large, wm_args, lat)
    records += pdl_kernel_checks(svc, full_batches, topk, lat)
    floor = launch_floor_ms(dev)
    for r in records:
        r.update(l1_latency_ns=lat["l1_ns"], l2_latency_ns=lat["l2_ns"],
                 dram_latency_ns=lat["dram_ns"], launch_floor_ms=floor)
        if r.get("latency_bound_ms") is not None:
            # what a lone launch of the kernel could take at best: the empty
            # kernel's time, then the slowest query's dependent reads
            r["floor_plus_latency_ms"] = floor + r["latency_bound_ms"]
    log("[kernels] device ms (empty-kernel floor " + f"{floor:.5f}): " + ", ".join(
        f"{r['name']} {r['device_ms']:.5f}"
        + (f" (floor + latency bound {r['floor_plus_latency_ms']:.5f})"
           if "floor_plus_latency_ms" in r else "") for r in records))
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["runtime"], paths["reference_engine"] = phase_runtime(
        svc, full_batches, topk, (backward_search, ilcp_list, pdl_gather, rank, rmq))
    log(f"[runtime] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["baselines"], base_records = phase_baselines(
        svc, full_data, full_batches, large, lat, (sada_c_list, ilcp_list, wt_list))
    for r in base_records:
        r.update(l1_latency_ns=lat["l1_ns"], l2_latency_ns=lat["l2_ns"],
                 dram_latency_ns=lat["dram_ns"], launch_floor_ms=floor,
                 floor_plus_latency_ms=floor + r["latency_bound_ms"])
    records += base_records
    log("[baselines] floor + latency bound ms: " + ", ".join(
        f"{r['name']} {r['floor_plus_latency_ms']:.5f} (device {r['device_ms']:.5f})"
        for r in base_records))
    il_rec = next(r for r in records if r["name"] == "ilcp_list")
    log(f"[baselines] the stored-DA ilcp_list kernel (Sada-I-D): device ms "
        f"{il_rec['device_ms']:.5f} (before its template on the DA source: 0.01446), "
        "integers equal to its plain version "
        "and to the host replay (phase 4)")
    baseline_s = time.perf_counter() - t0
    log(f"[baselines] phase {baseline_s:.1f} s")
    t0 = time.perf_counter()
    paths["sharded"], paths["tfidf_incremental"] = phase_sharded(
        dev, svc, full_batches, topk, (backward_search, ilcp_list, pdl_gather, rank, rmq))
    log(f"[sharded] phase {time.perf_counter() - t0:.1f} s; {nvidia_smi_line()}")
    t0 = time.perf_counter()
    phase_analysis(svc)
    log(f"[analysis] phase {time.perf_counter() - t0:.1f} s")
    del svc, full_batches, large, topk, full_data
    free_device_memory()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama3_2_3b.config(), attention_impl="flash")
    paths["lm_serve"], lm_runs, qkv, lm_checks = phase_lm(dev, flash_attention, cfg)
    log(f"[lm] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records.append(flash_kernel_checks(dev, qkv))
    records[-1].update(lm_checks, ptxas=build["kernels"], ptxas_warnings=build["warnings"])
    del qkv
    free_device_memory()
    log(f"[flash] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["embedding_bag"], bag_record = phase_embedding_bag(dev, embedding_bag)
    records.append(bag_record)
    log(f"[embag] phase {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(smollm_135m.config(), attention_impl="flash")
    paths["lm_train"], train_runs = phase_train(dev, flash_attention, cfg)
    flash_record = next(r for r in records if r["name"] == "flash_attention")
    flash_record.update({f"train_{k}": train_runs[k] for k in (
        "vjp_ms_per_layer", "vjp_max_bf16_ulps", "flash_fwd_device_ms_per_launch",
        "step_median_s", "tokens_per_s", "peak_gib", "f32_loss_rel")})
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(llama4_scout_17b_a16e.config(), n_layers=L4_LAYERS,
                              attention_impl="flash")
    paths["lm_llama4"], l4_runs = phase_llama4(dev, flash_attention, cfg)
    flash_record.update({f"llama4_{label}_{k}": v for label, r in l4_runs["kernel"].items()
                         for k, v in r.items()})
    log(f"[llama4] phase {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    paths["recsys"], recsys_runs = phase_recsys(dev, embedding_bag)
    bag_record.update(recsys_lookup={a: r["lookup"] for a, r in recsys_runs["serve"].items()})
    log(f"[recsys] phase {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    nequip_runs = phase_nequip(dev)
    log(f"[nequip] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["multirank"], multirank_runs = phase_multirank(dev, flash_attention)
    log(f"[multirank] phase {time.perf_counter() - t0:.1f} s")
    free_device_memory()
    t0 = time.perf_counter()
    paths["tp"], tp_runs = phase_tp(dev, flash_attention, embedding_bag)
    log(f"[tp] phase {time.perf_counter() - t0:.1f} s")
    log("[lm] runs " + json.dumps(lm_runs))
    log("[train] runs " + json.dumps(train_runs))
    log("[llama4] runs " + json.dumps(l4_runs))
    log("[recsys] runs " + json.dumps(recsys_runs))
    log("[nequip] runs " + json.dumps(nequip_runs))
    log("[multirank] runs " + json.dumps(multirank_runs))
    log("[tp] runs " + json.dumps(tp_runs))
    for r in records:
        # each kernel's launches on the paths that run it, each path counted
        # from 0 just before it ran
        r["launches_by_path"] = {p: c[r["name"]] for p, c in paths.items() if r["name"] in c}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": records}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
