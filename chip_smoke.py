#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Print the card's name and power limit; build the eight CUDA kernels
   (one ``nvcc`` per source, in parallel, into ``build/repro_torch/``),
   logging each entry function's registers and spilled bytes (ptxas);
   K4's backward kernel must spill none at any head-dim pair.
2. The graph path at full size: ``web_graph(scale=20)`` (1,048,576
   vertices, ~6.4 M edges) → ``GraphSession`` CLUGP partition at k = 64
   (one restream) → ``build_layout`` → 30 PageRank iterations over the
   halo exchange.  Launch counts are zeroed just before and read just
   after: every graph kernel (K1, the fused K2 over the CSR, K3, T) must
   have launched, K4 and the dense K2 not, and K1 exactly once per
   clustering pass (its pass walks the whole stream in one launch).
   Checks: RF below a uniform random assignment's, every partition load
   ≤ τ·E/k + 1, PageRank finite and within L1 1e-4 of the float64 oracle.
2b. The paper's parallel mechanism as ranks on this card (``[dist]``;
   the kernels are built before any rank is spawned, and every rank runs
   on cuda:0 over gloo, which stages through host memory).  At scale 16,
   4 stream slices, k = 64 with the graph path's profile: game off equal
   to the np host combine over 4 nodes edge for edge; game on equal to
   the same sharded run on 4 CPU ranks edge for edge (the rank-folded
   draws).  At scale 20 on 4 ranks: per-rank stage seconds, the restream
   count table's all-reduce seconds and bytes, the game each rank played,
   µs/edge and RF beside the one-card partition of phase 2; gates:
   balance ≤ τ + 0.05, RF below random's, every edge assigned.  Then a
   k = 8 partition of the same stream, its layout one partition a rank
   on 8 ranks: pagerank and cc for 30 iterations on all five wires, the
   fused (pagerank, ppr, centrality) bundle on halo, pagerank to tol 1e-6
   on halo and overlapped on ragged, each held against the stacked
   engine on the same layout (f32 rtol 1e-5, integers equal, tol
   iterations ±1; the lossy wires' pagerank within 5e-4 of the float64
   oracle, ``[exchange]``'s bound), with ms/iteration and the bytes every
   rank handed to the wire against ``comm_bytes``.  Every rank reports
   its launches: a partition rank K1 once a clustering pass, T twice, the
   CSR K2 when the game is on; a GAS rank K3 once an iteration of each
   program that gathers on it; nothing else.  In the same spawn the graph
   dry-run (``[dryrun]``, ``repro_torch.launch.dryrun.graph_cells``):
   every program on every wire, the fused quantized bundle and the three
   overlapped ragged cells, one iteration each through
   ``GraphSession.dryrun_step``; every cell's counted wire bytes equal
   ``comm_bytes`` (dense: (k−1)/k of it), ``check_graph_ordering`` finds
   nothing (the reference's CI gate), the overlap cells equal their
   phase-ordered cells in bytes and ring hops, and the session's stacked
   early exit (pagerank on ragged, tol 1e-6) stops under its cap of 60,
   its values within rtol 1e-5 of the fixed run (float atomics on the
   card).  Last, the sharded partitioner on one rank over NCCL.
3. The GAS program library on the same scale-20 layout (``[gas]``): all
   eight programs through ``sess.run`` on the halo and the dense
   exchange (f32 programs 30 iterations, min programs 40, degree 1, cc to
   its fixed point under a cap), each against its numpy oracle (integer
   programs equal, pagerank and ppr L1 ≤ 1e-4, centrality L1 relative to
   the oracle's ≤ 1e-4) and the integer ones equal across the exchanges;
   the fused bundles (pagerank, ppr, centrality) and (cc, labelprop,
   sssp, bfs) against their single runs and timed against them; pagerank
   and labelprop with early exit, then warm-started from their result
   (labelprop must end after one iteration with identical output,
   pagerank in fewer iterations than cold; the timed device loop of
   pagerank to tol within one iteration of ``sess.run``'s count and L1
   1e-4 of its vector).  Every run is counted on its
   own: K3 exactly once an iteration for each program that gathers on it
   (pagerank, ppr, centrality), no other kernel.  ms/iteration of every
   program and bundle (the second, synchronized run on the cached
   tables) and the oracles' host seconds.
3b. The other three wire formats on the same layout (``[exchange]``,
   nothing cut): the ring schedule (populated hops, sum of H_s), the
   lanes each exchange moves a phase, the interior share and the
   ``comm_bytes()`` table; every program through ``sess.run`` on
   quantized, ragged and ragged_quantized with ms/iteration of the device
   loop beside ``[gas]``'s halo and dense; ``overlap=True`` on the ragged
   two; both bundles on all three; pagerank to tol 1e-6 on quantized,
   cold and warm; the phase's peak memory (the profiler's device
   activities an iteration on all five wires are read after phase 4's
   kernel timings, in one session).  Counts zeroed before the phase
   and read after: K3 once an iteration of pagerank, ppr and centrality,
   no other kernel.  Checks: integer programs equal halo's with and
   without overlap; ragged (and its overlap) within rtol 1e-5 of halo;
   quantized and ragged_quantized pagerank's max-abs error to the float64
   oracle at 100 iterations below 1e-6 and below its error at 30
   (ragged_quantized overlapped too), the fused quantized pagerank within
   5e-4; in the byte model ragged <= halo <= dense and quantized < halo.
4. Every graph kernel against its plain PyTorch version on the card at
   the graph path's shapes (K1's pass on the first 2,048 blocks of the
   scale-20 stream: clu, deg, vol, scal and packed bit for bit, then timed
   over the whole stream; the dense K2 at M = the run's m_cap and k = 64;
   the fused K2 on every live batch of the run's game (its cluster CSR,
   assignment and loads), bit for bit on best, cost and the current cost;
   K3 on the run's row-split ELL; T on the inputs of both of the path's
   walks, the first pass's and the restream's, bit for bit against the
   plain walk and the tiered emulation, with its tier counts), timed on
   the device — CUDA events, or for K2, its CSR form and K3, whose
   launches are shorter than their wrappers' host time, the profiler's
   kernel times (the events' back-to-back rate beside them) — beside the
   least time the card could take for their bytes and operations (and,
   for K1 and T, whose dependent chains are what limits them, a latency
   floor) and, for K3, one PyTorch sparse call.
4b. Graph serving on the same resident session (``[graph-serve]``): a
   ``GraphServer`` answers the reference launcher's query mix (64 score
   queries over pagerank, degree, cc and labelprop, 4 vertices each, 4
   owner and 4 neighbors queries; microbatches of 16, 30 iterations),
   takes 3 windows of 65,536 uniformly random arrivals (each flush
   assigned on T from the resident loads under the grown cap; a
   restream of 2 passes whenever RF passes 1.02 × its baseline), serves
   the grown graph, then the same score mix cold and warm to tol 1e-6
   (cap 200).  Counts zeroed before and read after: T once a flush plus
   2 a restream, K3 once an iteration of every pagerank run, no other
   kernel.  Checks: integer replies equal direct runs and the host
   tables, pagerank within rtol 1e-5 (L1 1e-4 at tol; float atomics on
   the card), every load ≤ τ·E/k + 1 after each swap, RF after a
   restream ≤ the drift, warm fewer iterations than cold.  Then T from
   seeded loads on the first flush's inputs (under the grown cap and
   under the resident one, where the partitions at the balance start
   full) against its plain walk and the tiered emulation, tier counts
   included; and the kill/resume check at scale 16, k 64, through the
   launcher's child (``--child-snapshot``), which must die by SIGKILL.
   Prints the query ms, each swap's assign / RF / layout seconds, the RF
   trace, cold and warm iterations and ms, each round split into seed
   tables, device loop and collection, and the phase's peak memory; then
   drops the grown session, so the later phases hold no graph state.
5. At scale 16 the kernel path and the plain path on the card: the
   clustering state, the game-off assignment and the game-on assignment
   (the CSR game on the fused K2 against the dense plain game) must match
   bit for bit.  The same two partitions on the CPU must equal the card's
   edge for edge, with the same game rounds: the game's start and damping
   draws are a counter hash, the same on every device.
5b. ``[sweep]``: ``partition_sweep`` on the scale-20 stream over k = 16,
   64, 256 with the main path's profile (one restream): per k RF against
   a random assignment's, balance, stage seconds, µs/edge and game
   rounds.  Checks: RF below random and the largest partition within
   τ·E/k + 1 at every k; the k = 64 entry equals phase 2's partition
   edge for edge.
5c. ``[scan]``: ``kernel="scan"`` (the Gauss–Seidel game on G) at scale
   17, k = 64 (m_cap 32,768, under the reference's pair-key limit; scale
   16 if the graph's m_cap passes it), from a seeded start.  Counts
   zeroed before the card partition and read after: K1, G, T launched,
   G once a round, nothing else.  G against its plain version bit for
   bit on the first round's inputs (assignment, loads, moves; over every
   row and over the live prefix), timed beside its bound and latency
   floor; the whole scan partition on the card against the port on the
   CPU from the same start, edge for edge; the Jacobi CSR game's seconds
   on the same graph beside.
5d. ``[partition-cli]`` at scale 14, k = 64: the np backend (host
   oracle) and the torch backend, their RF and seconds; the np host
   combine over 4 nodes (per node); the five baselines' RF and host
   seconds; ``python -m repro_torch.launch.partition --scale 14 --k 64
   --algo clugp-opt --backend jit --pagerank`` as a subprocess, which
   must exit 0 and print the reference launcher's four lines.
6. The LM serving path: qwen2-7b at full width and depth (28 layers,
   7.6 B parameters) in bf16 from a seeded generator.  ``make_prefill_step``
   on 4 prompts of 2,048 tokens with the counts zeroed before and read
   after: K4 must launch once per layer, the graph kernels never; prefill
   tokens/s.  Then the serving launcher's loop (``launch.serve.generate``:
   4 prompts of 16 tokens by repeated decode, 32 greedy tokens), which
   launches no K4; ms/token-step beside its floor, the 15.2 GB of weights
   each step reads at 3.35 TB/s.  Logits finite throughout.
7. Cross-check: qwen2-7b cut to 2 layers at full width in f32; the last
   logits of ``prefill`` (K4) against the decode loop's logits at the last
   prompt position (dense attention, no K4) within 2e-3, the JAX package's
   own tolerance for decode against forward.
8. K4 against its plain version at the prefill shape (q 4×28×2048×128,
   k/v 4×4×2048×128, bf16, causal) within 2e-2 and at one f32 shape within
   2e-5; timed with CUDA events beside its bound (tensor-core operations)
   and ``scaled_dot_product_attention`` as a yardstick the port never
   calls, with K4's share of the prefill.
8a. ``[lm-mesh]``, the LM half of the mesh: qwen2-7b served tensor- and
   sequence-parallel over ``make_test_mesh(2, 4)``, 8 ranks sharing this
   card over gloo (the kernels built before the spawn; every rank sets
   the parent's TF32 flags), cut to its first 4 of 28 layers for the
   script's time (``LM_MESH_LAYERS``).  Phase 6 keeps its witness on the
   host (``lm_mesh_witness``, from its tree's first 4 layers): their
   prefill logits, the prompt, greedy tokens and logits after the
   prompt on the one card, the checksums of the blocks each model rank
   keeps, and the same weights' exact f32 twin's prefill logits and
   logits after the prompt.  On the ranks: f32 at full width on 2
   layers, the prefill's logits and 4 decode steps' within 1e-4 of the
   largest |logit| of the one card's on the same weights; then bf16 at
   full width, each rank replaying every draw of ``init_params`` (seed 0)
   and keeping its blocks (``place_params``; the blocks' checksums equal
   the witness's), a warm-up and the timed prefill of 4 × 2,048 (2 rows
   a data rank; K4 exactly 4 times a rank at (2, 7/1, 2048, 128)):
   logits within 2e-2 of the largest of the one card's, and within 1.2×
   of the one card's distance to the f32 twin, as are the logits after
   the prompt; ``generate`` (the prompt's first 4 tokens and 4 greedy
   tokens, cut from phase 6's 16 and 32 for time; no K4; how many tokens
   equal the one card's is logged, not gated: random weights make
   near-ties): each rank's block of its cache is (4, 2, 2, 4, 128),
   positions 2·m and 2·m + 1 on model rank m, every one written.  Logged: prefill ms and
   tokens/s, decode ms/token-step, peak memory and, by call site, every
   rank's collective seconds, bytes and calls; K4 at the rank's shape
   against its plain version and SDPA, alone on the card.
8a'. ``[pp]``: 8 of qwen2-7b's 28 layers (``PP_LAYERS``; 28 until
   ``[family-mesh]`` joined, cut for time) as 4 ``pipeline_apply`` stages
   of 2 on 4 ranks sharing the card (a "stage" mesh), 4 microbatches of
   (1, 2,048, 3,584) hidden states in 7 ticks; each layer drawn from its
   own seed, so the parent's ``reference_apply`` on one rank runs the
   same model: f32 with 1 layer a stage within 1e-4 of the largest |h|,
   bf16 at the phase's depth within 2e-2 (both bit-equal so far), timed
   beside ``reference_apply`` alone; K4 exactly 2 times a stage a
   microbatch, 7 ring hops; the bubble (S − 1)/(M + S − 1).
8b. ``[moe]``, with the qwen2 phases' memory freed: llama4-scout (16
   experts top-1 + a shared expert, GQA 40/8) at published width and 12
   of its 48 layers (the only cut), bf16, seeded.  The parameter count
   against ``param_count``; ``make_prefill_step`` on 4 × 2,048 tokens with
   the counts zeroed before and read after (K4 exactly once a layer, no
   graph kernel), tokens/s beside the FLOP ceiling from the code, peak
   memory, the share of routed tokens dropped by capacity and layer 0's
   expert load; ``generate`` (4 prompts of 16 tokens, 32 greedy tokens;
   no K4), ms/token-step beside the weight-read floor (every expert at
   capacity 1), every step's logits finite.  Then 2 layers in f32 at a
   capacity that drops nothing: prefill (K4) against the decode loop
   within 2e-3, ``moe_apply`` against ``moe_reference`` on layer 0's real
   input within 2e-4; K4 at the group-5 prefill shape against its plain
   version within 2e-2, timed beside its bound and SDPA.
   ``[moe-mesh]`` then serves llama4-scout at published width over
   make_test_mesh(2, 4) (8 ranks on this card over gloo) with its 16
   experts 4 a model rank (expert parallelism), cut to 1 of 48 layers
   (each data rank holds a whole copy of its model block; 12 layers would
   need ≈ 114 GB; 4 until ``[family-mesh]`` joined, cut for time).  f32 at 1 layer: prefill logits and 4 decode steps
   within 1e-4 of the largest |logit| of the one card's on the same
   weights, the routing's kept pairs equal.  bf16: every rank's blocks
   equal the one-card tree's by checksum (the ranks draw in turns);
   prefill 4 × 2,048 with the counts zeroed before and read after (K4
   exactly once a layer a rank, no graph kernel), logits within 2e-2 of
   the one card's, each layer's kept pairs within 2e-3 of its routed
   pairs of the one card's; ``generate`` (4-token prompts, 4 greedy
   tokens), every logit finite, the tokens equal to the one card's
   counted; per rank the
   collectives by site (``moe.combine`` among them); K4 at the rank's
   (2, 10/2, 2048, 128) by the profiler's device time beside SDPA.
8c. ``[mla]``, with ``[moe]``'s weights freed: deepseek-v3 (MLA, 128
   heads; 256 experts top-8 + a shared expert after 3 dense layers) at
   published width and 5 of its 61 layers (3 dense + 2 MoE, 26.6 B
   parameters, 49.58 GiB bf16; the only cut), seeded.  The parameter
   count against ``param_count``; ``make_prefill_step`` on 4 × 2,048
   tokens with the counts zeroed before and read after (K4 exactly once a
   layer at q/k 192, v 128, no graph kernel; the profiler's count of K4
   launches in a second prefill), tokens/s and TFLOP/s beside the FLOP
   ceiling, peak memory, the drop share and layer 3's expert load;
   ``generate`` (4 prompts of 16 tokens, 32 greedy tokens, decoded from
   the latent cache; no K4), ms/token-step beside the weight-read floor,
   every logit finite.  Then 2 dense layers at full width in f32: the
   decompressed prefill (K4 f32 at 192/128) against the absorbed decode
   loop within 2e-3; K4 at the prefill's shape (v a slice of kv_b's rows)
   against its plain version in bf16 (2e-2) and f32 (2e-5), timed beside
   its bound and SDPA (each fused backend tried alone).
8d. ``[ssm]``, with ``[mla]``'s weights freed: mamba2-130m at full width
   and depth (24 SSD layers, d_inner 1,536, 24 heads of 64, N = 128,
   chunk 128), then one 8-layer jamba period at published width (d_model
   8,192, GQA 64/8 of 128 at sublayer 3, d_ff 24,576, SSD d_state 128,
   heads of 64, MoE top-2 at every 2nd sublayer) with 8 of its 16 experts
   (16 are 90.29 GB in bf16; the width cut is logged), both bf16 and
   seeded.  For each: the parameter count against ``param_count`` and
   the published figure (167,616,960; 25,816,462,592);
   ``make_prefill_step`` on 4 × 2,048 tokens with the counts zeroed
   before and read after (mamba: no kernel; jamba: K4 exactly once, group
   8, D 128), tokens/s beside the FLOP ceiling, peak memory and jamba's
   drop share; ``ssd_chunked`` against the sequential ``ssd_reference`` on
   layer 0's real input within 1e-4 of its largest magnitude; ``generate``
   (4 prompts of 16 tokens, 32 greedy tokens, from the SSM state; no
   kernel), ms/token-step beside the floor of the weights and f32 state a
   step moves, every logit finite.  The f32 checks at full width on 4 ×
   256 tokens: every mixer (SSD sublayer; jamba's attention on K4 f32)
   fed its prefill input, its prefill form against its decode form
   stepped token by token within 1e-4 of its largest magnitude; prefill's
   last logits against the decode loop's within 2e-3 on mamba's first 2
   layers and on jamba's period (2 experts at a capacity that drops
   nothing), and logged for mamba's 24 layers (a random-weight stack that
   deep amplifies f32 rounding past 2e-3, in the reference too).  Then K4
   at (4, 64, 2048, 128) with k/v (4, 8, 2048, 128) against its plain
   version within 2e-2, timed beside its bound and SDPA.
8e. ``[encdec]``, with ``[ssm]``'s weights freed: seamless-m4t-large-v2
   at full width and depth (24 encoder + 24 decoder layers, d_model
   1,024, 16 heads of 64, layernorm, ungated FFN 8,192, vocab 256,206;
   nothing cut), bf16, seeded.  The parameter count against
   ``param_count`` and the published 1,632,356,352; ``make_prefill_step``
   on the JAX package's split of a 2,048-position prefill, 4 × (1,024
   seeded source frames as ``src_embeds`` + 1,024 tokens), with the
   counts zeroed before and read after: K4 exactly 72 times (24
   non-causal encoder self-attentions, 24 causal decoder self-attentions,
   24 non-causal cross-attentions), no other kernel; tokens/s beside the
   FLOP ceiling, peak memory; ``generate`` (4 prompts of 16 tokens, 32
   greedy tokens) against ``encode`` of the prefill's frames: K4 exactly
   24 times a step (the cross-attention at Sq = 1), ms/token-step beside
   its floor, every logit finite.  Then 2 + 2 layers at full width in f32
   on 77 source frames for 100 tokens (Sm != S): prefill's last logits
   against the decode loop's within 2e-3.  K4 at the prefill's shape (q,
   k, v (4, 16, 1024, 64), transposed views, not causal) and at the
   decode's (Sq = 1) against its plain version (2e-2; f32 2e-5), timed
   beside its bound and SDPA.
8f. ``[vlm]``, with ``[encdec]``'s weights freed: pixtral-12b at full
   width and depth (40 layers, d_model 5,120, GQA 32/8 of head dim 160,
   rope θ 1e9, d_ff 14,336, vocab 131,072; nothing cut), bf16, seeded.
   The parameter count against ``param_count`` and the published
   12,772,070,400; ``make_prefill_step`` on 4 × (256 seeded
   ``prefix_embeds`` + 1,792 tokens) with the counts zeroed before and
   read after: K4 exactly 40 times (causal, group 4, D 160), no other
   kernel; tokens/s beside the FLOP ceiling, peak memory; ``generate``
   (tokens only, as the reference's decode; no kernel), ms/token-step
   beside the weight-read floor, every logit finite.  Then 2 layers at
   full width in f32: prefill's last logits (K4 f32 at 160) against the
   decode loop's within 2e-3; K4 at (4, 32, 2048, 160) over k/v (4, 8,
   2048, 160) against its plain version (2e-2; f32 2e-5), timed beside
   its bound and SDPA.
8f'. ``[family-mesh]``, with ``[vlm]``'s weights freed: the other
   families served tensor- and sequence-parallel over the mesh, in bf16
   at published width, prefill 4 × 2,048 (seamless 1,024 frames + 1,024
   tokens) and ``generate`` (2-token prompts, 2 greedy tokens):
   deepseek-v3 (MLA + MoE; 1 dense + 1 MoE layer of 61, all 256
   experts, 64 a model rank), mamba2-130m (SSD, whole) and
   seamless-m4t-large-v2 (encoder–decoder, whole; decode attending the
   encoder's output of the prefill's frames) on make_test_mesh(2, 4), 8
   ranks in one spawn, then jamba (the hybrid: one period with 4 of its
   16 experts, one a model rank) on that spawn's first data line, a (1,
   4) mesh (``line_mesh``: two copies beside eight ranks'
   activations pass the card's 80 GB).
   The first data line's ranks draw in turns; the second's take their
   model peers' blocks over "data" (``drawn_over_data``).  Before the
   spawns the one card answers on the same draws (``family_one_card``)
   and K4 at the MLA rank's (2, 32/32, 2048, 192/128), jamba rank's
   (4, 16/2, 2048, 128) and seamless rank's shapes (2, 4/4, 1024, 64)
   non-causal (encoder, cross-attention) and causal (decoder), and Sq =
   1 over 1,024 keys (decode's cross-attention) is held against its
   plain version with p in f32 and in bf16 (2e-2), its profiler device
   time beside SDPA's and its bound.  Gates a model: f32 at the check's depth (deepseek's dense
   layer, mamba2's 2 layers, seamless 1 + 1, jamba's period cut to 2
   sublayers with the 4-expert MoE) the prefill logits and 4 decode
   steps' within 1e-4 of the one card's; bf16 prefill logits within
   2e-2 of the one card's at one layer (the f32 check's first layer or
   period in bf16), and at the phase's depth for the attention stacks
   (deepseek, seamless); mamba2's first ``FM_SSD_DEPTH`` layers held
   to their f32 twin within ``FM_SSD_TWIN_TOL``, the mesh and the one
   card alike (random SSD stacks are chaotic in bf16: its 24 layers and
   jamba's period are logged); every
   decode logit finite; K4 exactly once an attention layer a rank in
   prefill (seamless also once a decoder layer a decode step), no other
   kernel; the plan splits heads, experts and SSD's d_inner; each
   family's collective sites called (``ssd.norm``,
   ``ssd.out``, ``decode.ssd``, ``xattn.o``, ``decode.qkv`` ...).
   Logged: per rank and model prefill ms, decode ms/token-step, peak
   memory, collectives by site; the phase's seconds.
8g. ``[train]``, with ``[family-mesh]``'s weights freed: stablelm-1.6b at full
   width and depth (24 layers, d_model 2,048, 32 heads of 64, layernorm,
   ungated FFN 5,632, vocab 100,352; 1,367,543,808 parameters; nothing
   cut) trained on the card: f32 masters, bf16 compute
   (``make_train_step``), AdamW under the launcher's cosine schedule (lr
   3e-3, warmup 1), 10 steps of ``batch_at`` (8 × 2,048 tokens).  Per step
   the loss and ms/step with the counts zeroed before and read after: K4
   exactly 48 times (24 forward, 24 remat recompute) and its backward
   kernel (``flash_attention_bwd``) 24 times, no other kernel;
   tokens/s over steps 2–9 beside the ceiling (``train_flops``), peak
   memory.  Checks: losses finite, the last below the first; at step 0
   every gradient leaf finite and non-zero (a K4 with no gradient would
   leave the q/k/v projections at zero).  Then 2 layers at full width in
   f32: every gradient leaf through K4 and its backward (the f32 tensor
   code) against autograd through the plain version (1e-4 of each leaf's
   largest magnitude), and
   the AdamW step on the card against the CPU's (1e-5).  K4's forward
   (with the rows' log-sum-exp) and backward at (8, 32, 2048, 64) and
   (4, 28, 2048, 128) over (4, 4, 2048, 128) against the plain version and
   its autograd (2e-2), the backward kernel also against its rounding twin
   (5e-3 of each gradient's largest magnitude), the backward timed by the
   profiler's device time beside its bound, the tensor code it replaced
   and SDPA's backward, K4's forward + backward beside SDPA's; the
   backward kernel's share of a step.  Last, ``ft.run`` at the reduced config killed at step 5 by
   ``fail_at_step`` and resumed: the uninterrupted run's losses within
   rtol 1e-4.
8g'. ``[train-families]``, with ``[train]``'s weights freed: every other
   family trained at published width on the card, f32 masters and bf16
   compute through ``make_train_step``, the optimizer
   ``launch.dryrun.optimizer_default`` picks for the full config
   (Adafactor for llama4-scout, deepseek-v3 and jamba, AdamW for the
   rest), 3 steps of 4 × 2,048 positions (seamless 1,024 seeded frames +
   1,024 tokens a row, pixtral its 256 seeded prefix embeddings + 1,792
   tokens): mamba2-130m and seamless-m4t-large-v2 whole, pixtral-12b at 4
   of 40 layers, llama4-scout at 1 of 48 (all 16 experts), deepseek-v3 at
   1 dense + 1 MoE layer with 32 of 256 experts (top-8, the shared expert
   kept), jamba-1.5-large's period cut to 2 sublayers with 4 of 16
   experts.  Checks a model: the parameter count = ``param_count``;
   every loss finite (whether it falls is logged); at step 0 every
   gradient leaf finite and non-zero but the experts the routing gave no
   token, which are exactly zero (counted); each step K4 exactly twice
   an attention call (forward and remat recompute; seamless 3 calls a
   layer pair) and its backward kernel once a call, no other kernel
   (mamba2 none); an f32 witness at one layer (jamba its period,
   deepseek an MoE layer): every gradient leaf through K4 against
   autograd through the plain version within 1e-4.  Logged: ms/step,
   tokens/s beside ``train_flops``' ceiling, peak memory, the backward
   kernel's share of a step.  Then K4's backward kernel at pixtral's (4,
   32/8, 2048, 160) and MLA's (4, 128/128, 2048, 192/128) (v a slice of
   ``kv_b``'s rows, k the materialised ``kf``) against its rounding twin
   (5e-3) and plain autograd (2e-2), timed by the profiler's device time
   beside its bound, the tensor code and SDPA's backward (the backend
   the dispatcher takes, or "none accepts").
8h. ``[train-mesh]``, with ``[train]``'s weights freed: stablelm-1.6b at
   full width, its first 2 of 24 layers (``TRAIN_MESH_LAYERS``; cut for
   the script's time), trained ZeRO-3 over make_test_mesh(2, 4)
   (``place_params(mesh, zero=True)``: each weight's TP dim on "model",
   its other dim on "data"), 8 ranks on this card over gloo, held to the
   one card's run of the same 2 layers (``train_twin``: ``[train]``'s
   optimizer, schedule and batches).  f32 at 2 layers: the mesh's loss
   within rtol 1e-5 of the one card's ``make_train_step`` loss on the
   same weights and batch, every gradient leaf gathered by
   ``gather_tree`` within 1e-4 of its largest magnitude.  bf16: every
   rank's blocks equal the seed-0 tree cut on both axes by checksum; 2
   AdamW steps (3 until the graph dry-run joined, cut for time), the
   counts zeroed before each and read after (K4 exactly 4 times a rank a
   step and its backward kernel 2, no graph kernel); every loss finite
   and within 1e-3 of the one card's at its step, five leaves
   (``TRAIN_WITNESS``) after the last step within 0.05 of the one card's
   update after the same step, every gradient leaf gathered at step 0
   finite and non-zero;
   s/step and tokens/s beside ``train_flops``' ceiling, every rank's
   collectives by site (the gloo sums apart from the ZeRO gathers and
   reduce-scatters).  K4 at the rank's (4, 8/8, 2048, 64): forward with
   LSE and the backward kernel against the plain version and autograd
   (2e-2) and its rounding twin (5e-3), by the profiler's device time
   beside the bounds, the tensor code and SDPA.
9. The ``kernels`` JSON line (eleven rows; G's from ``[scan]``; K3's row
   also carries the
   ``[gas]`` and ``[exchange]`` phases' launches, T's the seeded walk of
   ``[graph-serve]``, K4's the ``[moe]`` and ``[ssm]`` prefills' and the
   ``[train]`` steps' (with the training shapes' records); K4 at
   MLA's head dims is a row of its own, ``flash_attention_mla``, with the
   ``[mla]`` prefill's launches, and so are K4 on the encoder–decoder
   path, ``flash_attention_encdec`` (non-causal at D 64; the prefill's
   and the decode's launches), and at head dim 160,
   ``flash_attention_d160`` (the ``[vlm]`` prefill's launches); K4's
   row also counts the ``[lm-mesh]`` ranks' timed prefill and the ``[pp]``
   stages' timed forward, with the rank shape's record, the
   ``[moe-mesh]`` ranks' timed prefill, ``[family-mesh]``'s jamba ranks'
   prefill and the ``[train-mesh]`` ranks' steps, with their rank
   shapes' records; the MLA row counts ``[family-mesh]``'s deepseek
   ranks' prefill with the MLA rank shape's record, the encoder–decoder
   row its seamless ranks' prefill and decode; K4's backward kernel is the
   row ``flash_attention_bwd``, timed at ``[train]``'s shape, with the
   ``[train]``, ``[train-families]`` and ``[train-mesh]`` steps' launches
   and ``[train-families]``' two shapes; the ``[train-families]`` steps'
   forward launches go to K4's row of their head dims), then the device
   JSON line last.

The mesh phases (``[lm-mesh]``, ``[moe-mesh]``, ``[family-mesh]``,
``[train-mesh]``) each hold every rank's counted windows to their dry
twin: the same rank's program run on the meta device under
``collectives.dry`` (``repro_torch.launch.dryrun``), in a thread beside
the rank's untimed f32 check (``dry_start``), joined before its first
timed window (``dry_join``); each window's collectives by site (bytes,
calls, ops) and the rank's parameter bytes must equal the real ones
(``dry_report``, ``dry_verdict``), and the dry peak estimate is logged
beside ``max_memory_allocated``.

The script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import gc
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE, EDGE_FACTOR, K = 20, 8, 64
SMALL_SCALE = 16
PASS_PREFIX = 2048               # blocks of K1's pass held against plain
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 dense tensor cores
K1_OPS_PER_EDGE = 150            # ALU operations of one edge's decisions
T_OPS_PER_EDGE = 8               # compares/selects/increment of one edge
K2_OPS_PER_LANE = 8              # flops of one (row, partition) cost
K2_OPS_PER_ENTRY = 4             # the fused K2's gather, match, add per entry
T_ONE_THREAD_MS = 744.63         # T when one thread walked every edge (PERF.md §6)
# K1 is one dependent chain of shared-memory steps, so its floor is
# latency, not bytes or operations: dependent edges x steps per edge x
# the load-to-use latency of one shared-memory read (about 29 cycles on
# Hopper in published microbenchmarks) at the card's top SM clock.  T's
# chain runs only through the chunks its warp walks (the frozen and exact
# tiers): one dependent step per 32-edge walk step and one per both-full
# edge (each reads the loads the one before wrote).
SMEM_STEP_CYCLES = 29
K1_STEPS_PER_EDGE = 2            # slot read -> volume read at that slot
T_WALK_STEP = 32                 # edges a walk step decides together
# the GAS phase on the graph path's layout: iterations per program (the
# min programs need their frontier to move; degree is exact after one),
# the programs that gather on K3, the fused bundles, the caps of the runs
# that end at a fixed point or a residual, and pagerank's tolerance
GAS_ITERS = {"pagerank": 30, "ppr": 30, "centrality": 30, "labelprop": 40,
             "sssp": 40, "bfs": 40, "degree": 1}
GAS_K3 = ("pagerank", "ppr", "centrality")
GAS_ITERS_ALL = tuple(GAS_ITERS) + ("cc",)
GAS_F32_BUNDLE = ("pagerank", "ppr", "centrality")
GAS_I32_BUNDLE = ("cc", "labelprop", "sssp", "bfs")
CC_CAP = GAS_CAP = 200
# pagerank's tolerance stays clear of the f32 noise of the hub's rank
# (191,269 in-edges summed by float atomics in a varying order): on an
# H100 at 1e-7, a restart from a vector converged to 1e-7 took 8
# iterations, the residual meeting the tolerance by chance
PR_TOL = 1e-6
# the graph-serving phase on the same resident session: the reference
# launcher's query mix (64 score queries over its four programs, 4
# vertices each, plus 4 owner and 4 neighbors queries; microbatches of 16,
# 30 iterations), then 3 windows of 65,536 uniformly random arrivals fed in
# quarter-window chunks (RF watermark 1.02, 2 restream passes), then the
# same score mix cold and warm to tol 1e-6 under a cap of 200; the
# kill/resume check runs the launcher's child at scale 16
SERVE_QUERIES, SERVE_BATCH, SERVE_ITERS = 64, 16, 30
SERVE_WINDOW, SERVE_WINDOWS = 65536, 3
SERVE_WATERMARK, SERVE_PASSES = 1.02, 2
SERVE_TOL, SERVE_CAP = 1e-6, 200
RESUME_SCALE = 16
# the rest of the partitioner: the k-sweep on the scale-20 stream, the
# scan game at the largest scale whose m_cap stays under the reference's
# pair-key limit, and the np backend, baselines and launcher at scale 14
SWEEP_KS = (16, 64, 256)
SCAN_SCALE = 17
CLI_SCALE = 14
# G's chain per cluster: the cost, five shuffle levels of the argmin, the
# move test and the update, each waiting on the one before
G_STEPS_PER_CLUSTER = 8
# the LM serving path: qwen2-7b at full width and depth
LM_ARCH = "qwen2_7b"
PREFILL_B, PREFILL_S = 4, 2048
SERVE_B, SERVE_PROMPT, SERVE_TOKENS = 4, 16, 32
CHECK_LAYERS, CHECK_B, CHECK_PROMPT = 2, 2, 100   # the f32 cross-check
F32_S = 300                                       # K4's f32 shape: S
# the MoE serving path: llama4-scout at published width, 12 of its 48
# layers (bf16 weights of all 48 come to ≈ 215.5 GB, of 12 to ≈ 57 GB);
# prefill and decode batches as the qwen2 path's
MOE_ARCH, MOE_LAYERS = "llama4_scout_17b_a16e", 12
MOE_TOKENS = 32
# the MLA serving path: deepseek-v3 at published width, 5 of its 61 layers
# (the 3 dense, then 2 MoE: 26,618,377,216 parameters = 49.58 GiB in bf16;
# 6 layers come to 71.0 GiB, which leaves no room for the prefill's
# dispatch buffers on an 80 GB card); batches as the qwen2 path's
MLA_ARCH, MLA_LAYERS = "deepseek_v3_671b", 5
MLA_PARAMS = 26_618_377_216
# the SSM and hybrid serving paths: mamba2-130m at full width and depth,
# and one 8-layer period of jamba at published width with 8 of its 16
# experts (16 come to 90.29 GB in bf16, above the card's 80 GB; 8 to
# 51.63 GB); the f32 checks at 4 × 256 tokens, jamba's with 2 experts
# (its f32 period is then 45 GB); batches as the qwen2 path's
SSM_ARCH, SSM_PARAMS = "mamba2_130m", 167_616_960
HYB_ARCH, HYB_EXPERTS, HYB_PARAMS = "jamba_1_5_large_398b", 8, 25_816_462_592
SSM_CHECK_B, SSM_CHECK_S, HYB_CHECK_EXPERTS = 4, 256, 2
SSD_REL_TOL = 1e-4        # ssd_chunked against the sequential oracle
SSM_LAYER_TOL = 1e-4      # a mixer's decode form against its prefill form
# the encoder-decoder and VLM serving paths, nothing cut: prefill on the
# JAX package's input split of a 2,048-position prefill
# (src/repro/launch/specs.py: seamless 1,024 source frames + 1,024 tokens,
# pixtral 256 prefix positions + 1,792 tokens), decode batches as the
# qwen2 path's; the f32 checks at 2 + 2 and 2 layers, seamless's on 77
# source frames for its 100 prompt tokens (Sm != S)
ENCDEC_ARCH, ENCDEC_PARAMS = "seamless_m4t_large_v2", 1_632_356_352
ENCDEC_SRC, ENCDEC_S = 1024, 1024
VLM_ARCH, VLM_PARAMS = "pixtral_12b", 12_772_070_400
CHECK_SRC = 77
# training on one card: stablelm-1.6b (the training launcher's default
# arch) at full width and depth, f32 masters, bf16 compute, AdamW under
# the launcher's cosine schedule (warmup steps // 10) on batch_at's
# stream; the gradient check at 2 layers of its width in f32; K4's
# forward and backward at the step's shape and at qwen2-7b's group 7;
# checkpoint-restart at the reduced config.  The run's arch, batch,
# sequence, steps and lr are repro_torch.profile's TRAIN_* (its training
# window profiles the same step)
TRAIN_PARAMS = 1_367_543_808
TRAIN_TIMED_FROM = 2                # steps from it on make tokens/s
GRAD_CHECK_B, GRAD_CHECK_S = 2, 512
FT_STEPS, FT_FAIL, FT_B, FT_S = 8, 5, 8, 128


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def latency_ms(edges, steps_per_edge, sm_hz):
    return edges * steps_per_edge * SMEM_STEP_CYCLES / sm_hz * 1e3


def check_path_launches(ops, launches, path):
    """Every kernel of ``path`` launched in its run, no other kernel."""
    for name in ops.KERNELS[path]:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched "
              f"on the {path} path")
    others = {n for p, names in ops.KERNELS.items() if p != path
              for n in names} - set(ops.KERNELS[path])
    check(not others & {n for n, c in launches.items() if c},
          f"the {path} path launched another path's kernel: {launches}")


def ptxas_entries(text) -> list:
    """(mangled kernel name, registers, spill bytes stored and loaded) of
    every entry function in ``nvcc -Xptxas -v`` output."""
    out, kernel, spill = [], None, 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            kernel, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel is not None:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi: {out.stderr.strip()}"


def event_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# device_ms: untimed calls at a profiler session's start, the length of
# the marker kernels (≈ 50.5 µs at 1,980 MHz) and how many of them make
# each boundary of the timed calls
PROFILER_WARM_CALLS = 2
PROFILER_MARK_CYCLES = 100_000
PROFILER_MARKS = 2
# the timings that no profiler session read whole, timed by CUDA events
# instead (``device_ms``); ``main`` lists them at the end
PROFILER_FALLBACKS: list = []


class Timed(float):
    """A time in ms and the timer that read it (``timed_by``)."""

    def __new__(cls, ms, timed_by):
        t = super().__new__(cls, ms)
        t.timed_by = timed_by
        return t


def timed_by(*times) -> str:
    """The timers that read ``times`` (``Timed``), each named once; a
    plain float is a host timer's (a CPU rehearsal's stand-in)."""
    return "; ".join(dict.fromkeys(getattr(t, "timed_by", "host timer")
                                   for t in times))


@functools.lru_cache(maxsize=1)
def sm_max_hz() -> float:
    """The card's top SM clock as nvidia-smi reads it."""
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def sessions_ms(sessions, reps, kernel=None, min_sessions=2):
    """What ``device_ms`` reads from its traced sessions — (ms, the kinds'
    counts a call) — or None while they do not suffice.  ``sessions``:
    per session of ``reps`` calls the (name, µs) of every device record it
    kept.  The card's profiler loses records (one of 50 K2 launches; late
    in the script 3–6 of 10 of each of SDPA's kinds, or every record of a
    session), so only a whole session is read: one that saw every kind
    that any session saw (with ``kernel``, the kinds whose name holds it)
    a whole, positive multiple of ``reps`` times, its count a call.  It
    gives the mean duration of a launch with ``kernel``, else the summed
    duration of a call.  With ``kernel`` None at least ``min_sessions``
    sessions are traced first, so a kind lost from every record of a
    session shows in another."""
    from collections import Counter
    kept = [[(n, us) for n, us in seen if kernel is None or kernel in n]
            for seen in sessions]
    kinds = {n for seen in kept for n, _us in seen}
    if not kinds or (kernel is None and len(sessions) < min_sessions):
        return None
    for seen in kept:
        c = Counter(n for n, _us in seen)
        if all(c[n] > 0 and c[n] % reps == 0 for n in kinds):
            us = sum(u for _n, u in seen)
            per_call = {n: c[n] // reps for n in kinds}
            return (us / len(seen) if kernel else us / reps) / 1e3, per_call
    return None


def device_ms(torch, fn, reps, kernel=None, max_sessions=12):
    """Mean device time of one launch of the kernels whose name holds
    ``kernel`` over ``reps`` calls of ``fn`` traced by torch.profiler; with
    ``kernel`` None, the device time of one call, every device activity
    of the call summed (the activities' names and counts a call are
    logged).  A kernel shorter than its wrapper's host-side launch cost is
    timed alone here; CUDA events around back-to-back calls would read
    the host's launch rate instead.  One untraced call first, then
    sessions until ``sessions_ms`` reads a whole one; ``max_sessions``
    without one fail the run.  The profiler loses a session's first
    records (the first call's one or two launches of a kind, in every
    session alike), so a session traces ``PROFILER_WARM_CALLS`` calls,
    then ``PROFILER_MARKS`` marker kernels (``torch.cuda._sleep``) back to
    back, the ``reps`` calls and as many markers again, and keeps the
    records between the two boundaries.  It also loses markers' records
    (with one marker a boundary, 27 of the 59 sessions of one whole run
    of this script on an H100 kept one or none of two); a boundary holds while one of its markers is
    kept, and the calls after the first boundary are kept when the last
    one is lost whole.  Now and then
    every duration of a session reads half its length (K4 and SDPA at
    0.020 ms against 0.040 in one session, 0.0288 against 0.060 in
    another); a marker spins ``PROFILER_MARK_CYCLES`` cycles, so it lasts
    at least that many at the top SM clock.  A session that lost the
    first boundary's every marker, or whose marker reads shorter than 0.9
    of that, keeps none.  Where ``max_sessions`` read none whole (on one
    H100 all six of a session cap lost SDPA's records at qwen2's mesh rank
    shape), the time is CUDA events' around ``reps`` back-to-back calls
    (with ``kernel``, over the launches a call counts), which reads the
    host's launch rate where a call is shorter than its launch; the
    result's ``timed_by`` says which timer read it, and the fallback is
    logged and listed at the end of the run."""
    from collections import Counter

    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    sessions = []
    for attempt in range(1, max_sessions + 1):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILER_WARM_CALLS):
                    fn()
                torch.cuda.synchronize()
                for _ in range(PROFILER_MARKS):
                    torch.cuda._sleep(PROFILER_MARK_CYCLES)
                for _ in range(reps):
                    fn()
                for _ in range(PROFILER_MARKS):
                    torch.cuda._sleep(PROFILER_MARK_CYCLES)
                torch.cuda.synchronize()
        # the kept markers by boundary (markers with no other record
        # between them), and the other records after each boundary
        marks, after = [], []
        for e in sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            if "spin_kernel" not in e.name:
                if marks:
                    after[-1].append((e.name, e.time_range.elapsed_us()))
                continue
            if not marks or after[-1]:
                marks.append([])
                after.append([])
            marks[-1].append(e.time_range.elapsed_us())
        floor_us = 0.9 * PROFILER_MARK_CYCLES / sm_max_hz() * 1e6
        short = [round(us, 2) for b in marks for us in b if us < floor_us]
        # one boundary alone is the first (the timed calls follow it) or
        # the last (nothing follows it: the session keeps nothing)
        whole = len(marks) == 1 or len(marks) == 2 and not after[1]
        sessions.append(after[0] if whole and not short else [])
        read = sessions_ms(sessions, reps, kernel)
        if read is not None:
            break
        seen = Counter(n for n, _us in sessions[-1]
                       if kernel is None or kernel in n)
        log(f"[profiler] session {attempt}, {kernel or 'every kind'} in "
            f"{reps} calls between the markers"
            f" ({sum(map(len, marks))} of {2 * PROFILER_MARKS} marker records "
            f"in {len(marks)} boundaries)"
            f"{f' (markers read {short} µs, < {floor_us:.1f})' * bool(short)}"
            f": { {n[:60]: c for n, c in seen.items()} }")
    if read is None:
        return device_ms_by_events(torch, fn, reps, kernel, len(sessions))
    ms, per_call = read
    spread = ""
    if kernel:
        us = [u for seen in sessions for n, u in seen if n in per_call]
        spread = f", a launch {min(us):.1f}–{max(us):.1f} µs"
    log(f"[profiler] {kernel or 'a call'}: {ms:.4f} ms after "
        f"{len(sessions)} sessions{spread}; launches a call "
        f"{ {n[:80]: c for n, c in per_call.items()} }")
    return Timed(ms, "profiler device time")


def device_ms_by_events(torch, fn, reps, kernel, sessions) -> Timed:
    """``device_ms``'s time where the profiler read no session whole: CUDA
    events around ``reps`` back-to-back calls, with ``kernel`` divided by
    the launches one call counts in the wrappers' counters."""
    from repro_torch.kernels import _build
    before = sum(_build.launch_counts().values())
    fn()
    torch.cuda.synchronize()
    per_call = max(1, sum(_build.launch_counts().values()) - before) \
        if kernel else 1
    ms = event_ms(torch, fn, reps) / per_call
    what = f"{kernel or 'every kind'} ({reps} calls)"
    timed_by = (f"CUDA events around back-to-back calls (the profiler read "
                f"no whole session in {sessions})")
    PROFILER_FALLBACKS.append(f"{what}: {ms:.4f} ms")
    log(f"[profiler] {what}: no whole session in {sessions}; {timed_by}: "
        f"{ms:.4f} ms" + (f" a launch, {per_call} launches a call"
                          if kernel else " a call"))
    return Timed(ms, timed_by)


def game_gs_in_partition(torch, run) -> dict:
    """G's launches and summed device time inside one scan partition
    (``run``), traced by torch.profiler, with that run's game stage
    seconds.  A measurement, not a check: the launch count is the
    wrappers' (checked elsewhere), this is what the profiler saw."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with warnings.catch_warnings():      # the profiler's one-cycle notice
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = run()
            torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "game_gs_kernel" in e.name]
    return dict(launches=len(us), ms=sum(us) / 1e3,
                game_s=res.stats["stage_seconds"]["game"])


def host_ms(torch, fn, reps=1):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def gas_phase(torch, ops, sess, g) -> dict:
    """The GAS program library on the session's scale-20 layout: every
    program through ``sess.run`` on both exchanges against its numpy
    oracle (sssp and bfs also from the vertex of largest out-degree), the
    fused bundles against their single runs, early exit and warm start.
    Each run is counted on its own: K3 exactly once an iteration for each
    program that gathers on it, no other kernel.  ms/iteration is the
    device loop alone (init and the iterations on the cached tables,
    synchronized), beside ``sess.run``'s end-to-end time, which adds the
    collection of the master values to the host.  Returns the phase's K3
    launches and its timings."""
    import numpy as np
    from repro_torch.dist.halo import get_exchange
    from repro_torch.graph import engine as eng
    V = g.num_vertices
    lay = sess.partition_layout
    hub = int(np.bincount(g.src, minlength=V).argmax())
    oracles = {
        "pagerank": lambda: eng.reference_pagerank(g.src, g.dst, V,
                                                   GAS_ITERS["pagerank"]),
        "ppr": lambda: eng.reference_ppr(g.src, g.dst, V, GAS_ITERS["ppr"]),
        "centrality": lambda: eng.reference_centrality(
            g.src, g.dst, V, GAS_ITERS["centrality"]),
        "cc": lambda: eng.reference_cc(g.src, g.dst, V),
        "labelprop": lambda: eng.reference_labelprop(g.src, g.dst, V,
                                                     GAS_ITERS["labelprop"]),
        "sssp": lambda: eng.reference_sssp(g.src, g.dst, V,
                                           GAS_ITERS["sssp"]),
        "bfs": lambda: eng.reference_bfs(g.src, g.dst, V, GAS_ITERS["bfs"]),
        "degree": lambda: eng.reference_degree(g.src, g.dst, V),
        "sssp@hub": lambda: eng.reference_sssp(g.src, g.dst, V,
                                               GAS_ITERS["sssp"], hub),
        "bfs@hub": lambda: eng.reference_bfs(g.src, g.dst, V,
                                             GAS_ITERS["bfs"], hub)}
    refs, oracle_s = {}, {}
    for name, fn in oracles.items():
        t = time.perf_counter()
        refs[name] = fn()
        oracle_s[name] = time.perf_counter() - t
    log("[gas] oracle host seconds " + json.dumps(
        {k: round(v, 3) for k, v in oracle_s.items()}))
    k3_total = 0

    def counted(fn, k3, what):
        """``fn()`` with the counts zeroed before and read after: K3
        exactly ``k3`` times (or ``k3(out)``), no other kernel."""
        nonlocal k3_total
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if callable(k3):
            k3 = k3(out)
        launched = {n: c for n, c in ops.launch_counts().items() if c}
        check(set(launched) <= set(ops.KERNELS["gas"]),
              f"{what} launched a kernel off the gas path: {launched}")
        check(launched.get("ell_spmv", 0) == k3, f"{what}: K3 launched "
              f"{launched.get('ell_spmv', 0)} times, not {k3}")
        k3_total += k3
        return out

    def timed(fn, k3, what):
        """``counted`` on an idle card, synchronized: (out, ms)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = counted(fn, k3, what)
        return out, (time.perf_counter() - t) * 1e3

    def loop(prog, it, ex, tol=None):
        """The device loop alone on the cached tables: (values, iters)."""
        dev = eng.stack_dev(lay, ex, sess.device)
        run = eng._sim_gas_many if isinstance(prog, eng.FusedGAS) \
            else eng._sim_gas
        return run(prog, dev, it, get_exchange(ex), tol)

    def per_iter(out):
        return out[1]

    ms_iter, iters_run, results = {}, {}, {}
    for ex in ("halo", "dense"):
        for name in ("pagerank", "ppr", "centrality", "labelprop", "sssp",
                     "bfs", "degree", "cc"):
            k3 = name in GAS_K3
            if name == "cc":
                def run(ex=ex):
                    return sess.run("cc", iters=CC_CAP, tol=0.0,
                                    exchange=ex, return_iters=True)
                out, it = counted(run, 0, f"cc on {ex}")
                check(it < CC_CAP, f"cc on {ex} did not reach its fixed "
                      f"point in {CC_CAP} iterations")
                (out2, _), run_ms = timed(run, 0, f"cc on {ex}")
            else:
                it = GAS_ITERS[name]

                def run(name=name, ex=ex, it=it):
                    return sess.run(name, iters=it, exchange=ex)
                out = counted(run, k3 * it, f"{name} on {ex}")
                out2, run_ms = timed(run, k3 * it, f"{name} on {ex}")
            _, loop_ms = timed(lambda: loop(eng.get_program(name, V), it, ex),
                               k3 * it, f"{name}'s loop on {ex}")
            check(out.shape == (V,), f"{name} on {ex}: shape {out.shape}")
            if name in GAS_K3:
                check(bool(np.isfinite(out).all()), f"{name} not finite")
            else:
                check(np.array_equal(out, out2), f"{name} on {ex} differs "
                      "between two runs")
            results[name, ex] = out
            iters_run[name, ex] = it
            ms_iter[name, ex] = loop_ms / it
            ref = refs[name]
            if name in GAS_K3:
                l1 = float(np.abs(out.astype(np.float64) - ref).sum())
                if name == "centrality":
                    l1 /= float(np.abs(ref).sum())
                check(l1 <= 1e-4, f"{name} on {ex}: L1 {l1:.3e} > 1e-4")
                err = f"L1 {l1:.3e}" + (" (relative)" if name == "centrality"
                                        else "")
            else:
                check(np.array_equal(out, ref), f"{name} on {ex} differs "
                      "from its numpy oracle")
                err = "equal to the oracle"
                if name != "degree":
                    err += (f"; {int((out != eng.CC_SENTINEL).sum())} of {V}"
                            " reached")
            log(f"[gas] {name} on {ex}: {it} iterations, {ms_iter[name, ex]:.4f}"
                f" ms/iteration (device loop {loop_ms:.3f} ms; sess.run "
                f"{run_ms:.3f} ms end to end), {err}")
        for name in ("sssp", "bfs"):
            prog = getattr(eng, f"{name}_program")(hub)
            out = counted(lambda prog=prog, ex=ex: sess.run(
                prog, iters=GAS_ITERS[name], exchange=ex), 0,
                f"{name} from {hub} on {ex}")
            check(np.array_equal(out, refs[f"{name}@hub"]), f"{name} from "
                  f"vertex {hub} on {ex} differs from its numpy oracle")
            log(f"[gas] {name} from vertex {hub} (largest out-degree) on "
                f"{ex}: equal to the oracle; "
                f"{int((out != eng.CC_SENTINEL).sum())} of {V} reached")
    for name in ("cc", "labelprop", "sssp", "bfs", "degree"):
        check(np.array_equal(results[name, "halo"], results[name, "dense"]),
              f"{name}: halo and dense differ")
    check(iters_run["cc", "halo"] == iters_run["cc", "dense"],
          "cc: halo and dense reach the fixed point in different counts")
    lanes = {ex: eng.stack_dev(lay, ex, sess.device)[route].numel()
             for ex, route in (("halo", "mirror"), ("dense", "gathered"))}
    log(f"[gas] every integer program equal on halo and dense; cc's fixed "
        f"point after {iters_run['cc', 'halo']} iterations; lanes a phase: "
        f"halo {lanes['halo']} (k^2 x H_max = {lay.k}^2 x {lay.h_max}) for "
        f"{lay.mirrors_total} mirrors, dense reduce {lanes['dense']} (one a "
        f"replica), dense broadcast {lay.k * lay.l_max} (k x L_max)")

    # the fused bundles: one exchange per phase for the whole bundle
    fused_ms = {}
    for ex in ("halo", "dense"):
        cc40 = counted(lambda ex=ex: sess.run(
            "cc", iters=GAS_ITERS["labelprop"], exchange=ex), 0, f"cc on {ex}")
        for bundle, it in ((GAS_F32_BUNDLE, 30), (GAS_I32_BUNDLE, 40)):
            k3 = it * sum(p in GAS_K3 for p in bundle)
            what = f"{'+'.join(bundle)} on {ex}"
            outs = counted(lambda bundle=bundle, it=it, ex=ex: sess.run_many(
                bundle, iters=it, exchange=ex), k3, what)
            fused = eng.fuse_programs([eng.get_program(p, V) for p in bundle])
            _, ms = timed(lambda fused=fused, it=it, ex=ex: loop(fused, it, ex),
                          k3, f"{what}, its loop")
            for name, out in zip(bundle, outs):
                single = cc40 if name == "cc" else results[name, ex]
                if name in GAS_K3:
                    d = float(np.abs(out.astype(np.float64) - single).sum()
                              / np.abs(single.astype(np.float64)).sum())
                    check(d <= 1e-5, f"fused {name} on {ex}: relative L1 "
                          f"{d:.3e} from its single run")
                else:
                    check(np.array_equal(out, single), f"fused {name} on "
                          f"{ex} differs from its single run")
            sep = sum(ms_iter[p, ex] for p in bundle)
            fused_ms["+".join(bundle), ex] = (ms / it, sep)
            log(f"[gas] fused {'+'.join(bundle)} on {ex}: {ms / it:.4f} "
                f"ms/iteration against {sep:.4f} run separately "
                f"({ms / it / sep:.2f}x); "
                + ("within relative L1 1e-5 of" if bundle == GAS_F32_BUNDLE
                   else "equal to") + " the single runs")

    # early exit and warm start: K3 once for each iteration run
    pr, pr_it = counted(lambda: sess.run("pagerank", iters=GAS_CAP,
                                         tol=PR_TOL, return_iters=True),
                        per_iter, "pagerank with tol")
    check(pr_it < GAS_CAP, f"pagerank did not reach tol {PR_TOL} in "
          f"{GAS_CAP} iterations")
    _, pr_wit = counted(lambda: sess.run("pagerank", iters=GAS_CAP,
                                         tol=PR_TOL, init_values=pr,
                                         return_iters=True),
                        per_iter, "warm pagerank")
    check(pr_wit < pr_it, f"warm pagerank took {pr_wit} iterations, cold "
          f"{pr_it}")
    lp, lp_it = counted(lambda: sess.run("labelprop", iters=GAS_CAP, tol=0.0,
                                         return_iters=True), 0,
                        "labelprop to its fixed point")
    check(lp_it < GAS_CAP, "labelprop did not reach its fixed point")
    lp_w, lp_wit = counted(lambda: sess.run(
        "labelprop", iters=GAS_CAP, tol=0.0, init_values=lp,
        return_iters=True), 0, "warm labelprop")
    check(lp_wit == 1 and np.array_equal(lp_w, lp),
          f"labelprop from its fixed point: {lp_wit} iterations, output "
          f"{'identical' if np.array_equal(lp_w, lp) else 'changed'}")
    log(f"[gas] early exit: pagerank at tol {PR_TOL} after {pr_it} "
        f"iterations, from its converged vector after {pr_wit}; labelprop's "
        f"fixed point after {lp_it} iterations, from it after {lp_wit} with "
        "identical output")
    (pr_loop, pr_loop_it), pr_ms = timed(
        lambda: loop(eng.get_program("pagerank", V), GAS_CAP, "halo",
                     PR_TOL), per_iter, "pagerank's loop with tol")
    # the hub's rank is summed by float atomics in a varying order on the
    # card, so two runs of one f32 early-exit loop may stop an iteration
    # apart (the port's rule for f32 tol exits, ROADMAP Queue 3); the
    # vector it stops at is held to sess.run's at the rule's L1 1e-4
    pr_loop_l1 = float(np.abs(eng.collect_master_values(lay, pr_loop)
                              .astype(np.float64) - pr).sum())
    check(abs(pr_loop_it - pr_it) <= 1 and pr_loop_l1 <= 1e-4,
          f"pagerank's loop with tol ran {pr_loop_it} iterations to L1 "
          f"{pr_loop_l1:.3e} of sess.run's vector, sess.run {pr_it}")
    (_, it), lp_ms = timed(lambda: loop(eng.get_program("labelprop", V),
                                        GAS_CAP, "halo", 0.0),
                           0, "labelprop's loop with tol")
    check(it == lp_it, "labelprop's loop with tol ran another count")
    tol_ms = {"pagerank": pr_ms / pr_loop_it, "labelprop": lp_ms / lp_it}
    log(f"[gas] early exit reads the residual back once an iteration: "
        f"pagerank {tol_ms['pagerank']:.4f} ms/iteration with tol ({pr_loop_it}"
        f" iterations this run, sess.run {pr_it}, L1 {pr_loop_l1:.3e} to its "
        f"vector) against "
        f"{ms_iter['pagerank', 'halo']:.4f} without, labelprop "
        f"{tol_ms['labelprop']:.4f} against {ms_iter['labelprop', 'halo']:.4f}")
    log(f"[gas] K3 launches in the phase {k3_total}")
    # what only this phase built goes (the dense exchange's tables, the
    # bundles' routes), so the later phases' memory readings hold what
    # they held before it
    lay.cache.pop((str(sess.device), "dense"))
    lay.cache[(str(sess.device), "halo")]["routes"].clear()
    torch.cuda.empty_cache()
    return dict(k3=k3_total, ms_iter={f"{n}/{e}": v
                                      for (n, e), v in ms_iter.items()},
                fused={f"{n}/{e}": v for (n, e), v in fused_ms.items()},
                tol_ms_iter=tol_ms,
                iters={"cc": iters_run["cc", "halo"], "pagerank_tol": pr_it,
                       "pagerank_warm": pr_wit, "labelprop_fixed": lp_it,
                       "labelprop_warm": lp_wit},
                oracle_s=oracle_s,
                halo={n: results[n, "halo"] for n in GAS_ITERS_ALL},
                cc40=cc40, refs=refs)


def exchange_activities(torch, sess, iters=3) -> dict:
    """Device activities (kernels, copies, fills) an iteration of pagerank
    and labelprop's device loops on all five wires of the session's
    layout, from one profiler session after a warm-up step: each loop
    runs ``iters`` and then 2·``iters`` iterations, each run followed by a
    marker kernel (``torch.cuda._sleep``), and the difference of a pair
    over ``iters`` leaves out the run's set-up.  The card's profiler loses
    records in some sessions (it lost 1–2 of 50 in the K2 timing after
    twenty short sessions), so a session whose markers do not all arrive
    is run again, twice at most, and then reads "not measured".  Builds
    and then drops the other wires' tables."""
    from torch.autograd import DeviceType
    from repro_torch.dist.halo import EXCHANGE_NAMES, get_exchange
    from repro_torch.graph import engine as eng
    lay = sess.partition_layout
    runs = {}
    for ex in EXCHANGE_NAMES:
        dev = eng.stack_dev(lay, ex, sess.device)
        for name in ("pagerank", "labelprop"):
            prog = eng.get_program(name, sess.num_vertices)
            runs[name, ex] = (lambda n, prog=prog, dev=dev, ex=ex: eng._sim_gas(
                prog, dev, n, get_exchange(ex, lay)))
    for fn in runs.values():
        fn(iters)
    torch.cuda.synchronize()

    def marker():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    want = 2 * len(runs) + 1
    for attempt in range(1, 4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                     active=1, repeat=1)
                    ) as prof:
                marker()
                prof.step()
                for _ in range(4):
                    marker()
                for fn in runs.values():
                    for n in (iters, 2 * iters):
                        fn(n)
                        torch.cuda.synchronize()
                        marker()
                prof.step()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        between = []
        for e in events:
            if "spin_kernel" in e.name:
                between.append(0)
            elif between:
                between[-1] += 1
        complete = len(between) == want + 3
        log(f"[exchange] profiler session {attempt}: {len(between)} marker "
            f"kernels of {want + 3} sent, {len(events)} device activities"
            + ("" if complete else "; records lost"))
        if complete:
            break
    for ex in EXCHANGE_NAMES:
        if ex != "halo":
            lay.cache.pop((str(sess.device), ex))
    torch.cuda.empty_cache()
    if not complete:
        return {key: None for key in runs}
    counts = between[-want:-1]
    return {key: (counts[2 * i + 1] - counts[2 * i]) / iters
            for i, key in enumerate(runs)}


def exchange_phase(torch, ops, sess, g, gas) -> dict:
    """The quantized, ragged and ragged-quantized wires on the session's
    scale-20 layout, right after ``[gas]``: the ring schedule, the lanes
    each exchange moves, the interior share and the byte model; every
    program through ``sess.run`` on each (ms/iteration of the device loop
    beside ``[gas]``'s halo and dense), both fused bundles, ``overlap=True``
    on the ragged two, pagerank to tol on quantized and the phase's peak
    memory.  The counts are zeroed
    before the phase and read after: K3 once an iteration of each program
    that gathers on it, no other kernel.  Checks (the reference's bounds):
    integer programs equal halo's, with and without overlap; ragged within
    rtol 1e-5 of halo and its overlap of phase-ordered; the quantized and
    ragged-quantized pagerank's max-abs error to the float64 oracle at 100
    iterations below 1e-6 and below its error at 30, the ragged-quantized
    one overlapped too (the 30-iteration errors printed beside the
    reference's bound and the CPU's run on this layout); the fused
    quantized pagerank within 5e-4 of the oracle; ragged <= halo <= dense
    and quantized < halo in the byte model."""
    import numpy as np
    from repro_torch.dist.halo import get_exchange
    from repro_torch.graph import engine as eng
    V = g.num_vertices
    lay = sess.partition_layout
    dkey = str(sess.device)
    new = ("quantized", "ragged", "ragged_quantized")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()

    sched = lay.halo_schedule()
    hops = [h for h in sched if h]
    ex_rq = get_exchange("ragged_quantized", lay)
    lanes = {"dense": (len(eng.stack_dev(lay, "dense", sess.device)
                           ["gathered"]), lay.k * lay.l_max),
             "halo": (lay.k * lay.k * lay.h_max,) * 2,
             "quantized": (lay.k * lay.k * lay.h_max,) * 2,
             "ragged": (len(eng.stack_dev(lay, "ragged", sess.device)
                            ["ring_mirror"]),) * 2,
             "ragged_quantized": (lay.k * sum(hops),) * 2}
    shipped = lay.k * sum(ex_rq._top(h) for h in hops)
    lay.cache.pop((dkey, "dense"))
    replicas = int(lay.vert_mask.sum())
    inter = lay.interior_frontier_stats()
    table = lay.comm_bytes()
    log(f"[exchange] ring schedule: {len(hops)} of {lay.k - 1} hops "
        f"populated, sum H_s {sum(hops)} (max H_s {max(hops)}, H_max "
        f"{lay.h_max}); {lay.mirrors_total} mirrors = {int(lay.halo_cnt.sum())}"
        f" halo_cnt lanes = {replicas} replica slots - {V} vertices")
    log("[exchange] lanes a phase (reduce, broadcast): " + "; ".join(
        f"{n} {a:,} / {b:,}" for n, (a, b) in lanes.items())
        + f" (ragged: the real lanes of the ring's {lay.k * sum(hops):,}; "
        f"ragged_quantized ships {shipped:,} of its lanes)")
    log(f"[exchange] interior share {inter['interior_frac']:.6f} (min over "
        f"partitions {inter['interior_frac_min']:.6f})")
    log("[exchange] comm_bytes per iteration " + json.dumps(table))
    check(table["ragged"] <= table["halo"] <= table["dense_gather"],
          f"byte model: ragged <= halo <= dense broken: {table}")
    check(table["quantized"] < table["halo"],
          f"byte model: quantized not below halo: {table}")

    k3_total = 0

    def counted(fn, k3, what):
        """``fn()`` with K3 launched ``k3`` times (or ``k3(out)``) in it
        and no other kernel: the counts' change over the call."""
        nonlocal k3_total
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if callable(k3):
            k3 = k3(out)
        delta = {n: c - before.get(n, 0)
                 for n, c in ops.launch_counts().items()
                 if c != before.get(n, 0)}
        check(set(delta) <= set(ops.KERNELS["gas"]),
              f"{what} launched a kernel off the gas path: {delta}")
        check(delta.get("ell_spmv", 0) == k3, f"{what}: K3 launched "
              f"{delta.get('ell_spmv', 0)} times, not {k3}")
        k3_total += k3
        return out

    def loop(prog, it, ex, tol=None, overlap=False):
        dev = eng.stack_dev(lay, ex, sess.device)
        run = eng._sim_gas_many if isinstance(prog, eng.FusedGAS) \
            else eng._sim_gas
        return run(prog, dev, it, get_exchange(ex, lay), tol, None, overlap)

    def timed_loop(prog, it, ex, k3, what, tol=None, overlap=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = counted(lambda: loop(prog, it, ex, tol, overlap), k3, what)
        return out, (time.perf_counter() - t) * 1e3

    refs = dict(gas["refs"])
    refs["pagerank@100"] = eng.reference_pagerank(g.src, g.dst, V, 100)

    def max_abs(out, ref):
        return float(np.abs(out.astype(np.float64) - ref).max())

    def rel_l1(out, ref):
        return float(np.abs(out.astype(np.float64) - ref).sum()
                     / np.abs(ref).sum())

    ms_iter, errs = {}, {}
    for ex in new:
        for name in ("pagerank", "ppr", "centrality", "labelprop", "sssp",
                     "bfs", "degree", "cc"):
            k3 = name in GAS_K3
            if name == "cc":
                out, it = counted(lambda ex=ex: sess.run(
                    "cc", iters=CC_CAP, tol=0.0, exchange=ex,
                    return_iters=True), 0, f"cc on {ex}")
                check(it == gas["iters"]["cc"], f"cc on {ex}: fixed point "
                      f"after {it} iterations, halo {gas['iters']['cc']}")
            else:
                it = GAS_ITERS[name]
                out = counted(lambda name=name, ex=ex, it=it: sess.run(
                    name, iters=it, exchange=ex), k3 * it, f"{name} on {ex}")
            _, ms = timed_loop(eng.get_program(name, V), it, ex, k3 * it,
                               f"{name}'s loop on {ex}")
            ms_iter[name, ex] = ms / it
            check(out.shape == (V,), f"{name} on {ex}: shape {out.shape}")
            halo = gas["halo"][name]
            if name in GAS_K3:
                check(bool(np.isfinite(out).all()), f"{name} on {ex} not "
                      "finite")
                if ex == "ragged":
                    check(np.allclose(out, halo, rtol=1e-5, atol=0.0),
                          f"{name} on ragged not within rtol 1e-5 of halo")
                errs[name, ex] = max_abs(out, refs[name])
                err = (f"max |d| {errs[name, ex]:.3e}, relative L1 "
                       f"{rel_l1(out, refs[name]):.3e} to the oracle")
            else:
                check(np.array_equal(out, halo), f"{name} on {ex} differs "
                      "from halo")
                err = "equal to halo"
            log(f"[exchange] {name} on {ex}: {it} iterations, "
                f"{ms_iter[name, ex]:.4f} ms/iteration (halo "
                f"{gas['ms_iter'][f'{name}/halo']:.4f}, dense "
                f"{gas['ms_iter'][f'{name}/dense']:.4f}); {err}")
    # the lossy wires converge on the fixed point instead of dithering at
    # a quantization step: the error at 100 iterations below 1e-6 and
    # below the error at 30 (the reference's bound at 30, 1e-5 for
    # quantized, was set on a 400-vertex graph; the same pagerank on the
    # CPU, on this layout, gives the 30-iteration error printed beside it)
    err100 = {}
    for ex in ("quantized", "ragged_quantized"):
        out = counted(lambda ex=ex: sess.run("pagerank", iters=100,
                                             exchange=ex), 100,
                      f"pagerank 100 on {ex}")
        err100[ex] = max_abs(out, refs["pagerank@100"])
        check(err100[ex] < 1e-6 and err100[ex] < errs["pagerank", ex],
              f"{ex} pagerank: max |d| {err100[ex]:.3e} at 100 iterations, "
              f"{errs['pagerank', ex]:.3e} at 30")
        if ex == "ragged_quantized":
            pr100 = out
    t = time.perf_counter()
    cpu_q = eng.simulate_gas(eng.get_program("pagerank", V), lay, 30,
                             "quantized", device="cpu")
    cpu_s = time.perf_counter() - t
    for key in [k for k in lay.cache if k[0] == "cpu"]:
        lay.cache.pop(key)
    log(f"[exchange] pagerank max |d| to the oracle at 30 iterations, then "
        f"100: quantized {errs['pagerank', 'quantized']:.3e} (the "
        f"reference's bound at 30: 1e-5; the CPU's run on this layout "
        f"{max_abs(cpu_q, refs['pagerank']):.3e}, {cpu_s:.1f} s), "
        f"{err100['quantized']:.3e}; ragged_quantized "
        f"{errs['pagerank', 'ragged_quantized']:.3e}, "
        f"{err100['ragged_quantized']:.3e}")

    # overlap on the ragged two: the interior applied apart from the ring
    over = {}
    for ex in ("ragged", "ragged_quantized"):
        for name in ("pagerank", "ppr", "centrality", "labelprop", "sssp",
                     "bfs", "degree"):
            it = GAS_ITERS[name]
            k3 = (name in GAS_K3) * it
            out = counted(lambda name=name, ex=ex, it=it: sess.run(
                name, iters=it, exchange=ex, overlap=True), k3,
                f"{name} on {ex} with overlap")
            _, ms = timed_loop(eng.get_program(name, V), it, ex, k3,
                               f"{name}'s overlapped loop on {ex}",
                               overlap=True)
            over[name, ex] = ms / it
            if name not in GAS_K3:
                check(np.array_equal(out, gas["halo"][name]), f"{name} on "
                      f"{ex} with overlap differs from halo")
            elif ex == "ragged":
                base = counted(lambda name=name, it=it: sess.run(
                    name, iters=it, exchange="ragged"), k3,
                    f"{name} on ragged")
                check(np.allclose(out, base, rtol=1e-5, atol=0.0),
                      f"{name} on ragged: overlap not within rtol 1e-5 of "
                      "phase-ordered")
            log(f"[exchange] {name} on {ex} with overlap: "
                f"{over[name, ex]:.4f} ms/iteration against "
                f"{ms_iter[name, ex]:.4f} phase-ordered")
        out, it = counted(lambda ex=ex: sess.run(
            "cc", iters=CC_CAP, tol=0.0, exchange=ex, overlap=True,
            return_iters=True), 0, f"cc on {ex} with overlap")
        check(np.array_equal(out, gas["halo"]["cc"])
              and it == gas["iters"]["cc"], f"cc on {ex} with overlap "
              "differs from halo")
    pr_over = counted(lambda: sess.run("pagerank", iters=100, overlap=True,
                                       exchange="ragged_quantized"), 100,
                      "overlapped pagerank 100 on ragged_quantized")
    over_err = max_abs(pr_over, refs["pagerank@100"])
    check(over_err < 1e-6 and over_err < errs["pagerank", "ragged_quantized"],
          f"overlapped ragged_quantized pagerank: max |d| {over_err:.3e} at "
          "100 iterations")
    log(f"[exchange] overlapped ragged_quantized pagerank at 100 iterations: "
        f"max |d| {over_err:.3e} to the oracle, {max_abs(pr_over, pr100):.3e}"
        f" to the phase-ordered run (float atomics vary the codes on the "
        "card)")

    # the fused bundles on the three wires
    fused_ms = {}
    for ex in new:
        for bundle, it in ((GAS_F32_BUNDLE, 30), (GAS_I32_BUNDLE, 40)):
            k3 = it * sum(p in GAS_K3 for p in bundle)
            what = f"{'+'.join(bundle)} on {ex}"
            outs = counted(lambda bundle=bundle, it=it, ex=ex: sess.run_many(
                bundle, iters=it, exchange=ex), k3, what)
            fused = eng.fuse_programs([eng.get_program(p, V) for p in bundle])
            _, ms = timed_loop(fused, it, ex, k3, f"{what}, its loop")
            notes = []
            for name, out in zip(bundle, outs):
                if name in GAS_K3:
                    check(bool(np.isfinite(out).all()), f"fused {name} on "
                          f"{ex} not finite")
                    notes.append(f"{name} max |d| "
                                 f"{max_abs(out, refs[name]):.3e}")
                    if ex == "ragged":
                        check(np.allclose(out, gas["halo"][name], rtol=1e-5,
                                          atol=0.0), f"fused {name} on "
                              "ragged not within rtol 1e-5 of halo")
                else:
                    single = gas["cc40"] if name == "cc" \
                        else gas["halo"][name]
                    check(np.array_equal(out, single), f"fused {name} on "
                          f"{ex} differs from halo")
            if ex == "quantized" and bundle == GAS_F32_BUNDLE:
                e = max_abs(outs[0], refs["pagerank"])
                check(e < 5e-4, f"fused quantized pagerank max |d| {e:.3e}")
            fused_ms["+".join(bundle), ex] = ms / it
            log(f"[exchange] fused {what}: {ms / it:.4f} ms/iteration "
                f"(halo {gas['fused']['+'.join(bundle) + '/halo'][0]:.4f}); "
                + ("; ".join(notes) if notes else "equal to halo"))

    # early exit and warm start on the quantized wire
    pr, pr_it = counted(lambda: sess.run(
        "pagerank", iters=GAS_CAP, tol=PR_TOL, exchange="quantized",
        return_iters=True), lambda out: out[1], "pagerank with tol on "
        "quantized")
    check(pr_it < GAS_CAP, "quantized pagerank did not reach its tol")
    _, pr_wit = counted(lambda: sess.run(
        "pagerank", iters=GAS_CAP, tol=PR_TOL, exchange="quantized",
        init_values=pr, return_iters=True), lambda out: out[1],
        "warm pagerank on quantized")
    log(f"[exchange] pagerank to tol {PR_TOL} on quantized: {pr_it} "
        f"iterations (halo {gas['iters']['pagerank_tol']}), warm from its "
        f"vector {pr_wit} (halo {gas['iters']['pagerank_warm']}; the lane "
        "references restart from zero)")

    launches = {n: c for n, c in ops.launch_counts().items() if c}
    check_path_launches(ops, launches, "gas")
    check(launches.get("ell_spmv", 0) == k3_total, f"K3 launched "
          f"{launches.get('ell_spmv', 0)} times in the phase, the runs "
          f"account for {k3_total}")
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    for ex in new:
        lay.cache.pop((dkey, ex))
    torch.cuda.empty_cache()
    log(f"[exchange] K3 launches in the phase {k3_total}; phase "
        f"{phase_s:.1f} s; peak device memory {peak / 2**30:.2f} GiB "
        f"({resident / 2**30:.3f} resident before it)")
    return dict(k3=k3_total, ms_iter={f"{n}/{e}": v
                                      for (n, e), v in ms_iter.items()},
                overlap_ms_iter={f"{n}/{e}": v for (n, e), v in over.items()},
                fused={f"{n}/{e}": v for (n, e), v in fused_ms.items()},
                lanes=lanes, peak_gib=peak / 2**30, phase_s=phase_s)


def graph_serve_phase(torch, ops, sess, g, t_row, event=None) -> dict:
    """Graph serving on the resident scale-20 session: the launcher's
    query mix before ingestion (replies against direct runs), three
    windows of live arrivals (each flush assigned on T from the resident
    loads; restreams past the RF watermark), the grown graph queried, the
    mix cold and warm to a tolerance, all with the launch counts zeroed
    before and read after: T once a flush plus ``SERVE_PASSES`` a restream,
    K3 once an iteration of every pagerank run, no other kernel.  Then T
    from seeded loads against its plain walk and the tiered emulation on
    the first flush's inputs, and the kill/resume check at scale 16 in a
    child process.  Adds the seeded walk to T's row (``t_row``)."""
    import argparse
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.stages import stream_state
    from repro_torch.core.transform import host_exact_cap, majority_vertex_map
    from repro_torch.launch import serve_graph as sg
    from repro_torch.serve import GraphServer
    event = event or event_ms
    cfg = sess.cfg.clugp
    dev = sess.device
    args = argparse.Namespace(
        device=str(dev), scale=SCALE, k=K, exchange="halo", backend="torch",
        iters=SERVE_ITERS, tol=None, seed=0, queries=SERVE_QUERIES,
        max_batch=SERVE_BATCH, window=SERVE_WINDOW,
        ingest_windows=SERVE_WINDOWS, watermark=SERVE_WATERMARK,
        restream_passes=SERVE_PASSES, ckpt_dir=None)
    args_tol = argparse.Namespace(**{**vars(args), "tol": SERVE_TOL,
                                     "iters": SERVE_CAP})
    src0, dst0 = sess.edges
    assign0, E0, V = sess.assign, len(sess.edges[0]), sess.num_vertices

    # every K3 launch the phase should make: one an iteration of each run
    # that holds pagerank, the server's and the checks' direct runs alike
    k3_expected = 0
    inner = sess.run_many

    def counting_run_many(progs, **kw):
        nonlocal k3_expected
        want_iters = kw.pop("return_iters", False)
        outs, iters_run = inner(progs, return_iters=True, **kw)
        names = [p if isinstance(p, str) else p.name for p in progs]
        k3_expected += iters_run * sum(n in GAS_K3 for n in names)
        return (outs, iters_run) if want_iters else outs

    sess.run_many = counting_run_many
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = GraphServer(sess, max_batch=SERVE_BATCH, window=SERVE_WINDOW,
                      rf_watermark=SERVE_WATERMARK,
                      restream_passes=SERVE_PASSES, iters=SERVE_ITERS)
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    try:
        tickets = sg.submit_mix(srv, args, args.seed + 1)
        replies, query_ms = sg.serve_mix(srv, tickets)
        sg.check_replies(srv, tickets, replies, sg.direct_run(sess, args),
                         None)
        log(f"[graph-serve] before ingestion: {len(tickets)} queries in "
            f"{srv.stats['microbatches']} microbatches, {query_ms:.3f} "
            f"ms/query ({SERVE_ITERS} iterations); integer, owner and "
            f"neighbors replies equal the direct runs and the tables, "
            f"pagerank within rtol {sg.REPLY_RTOL}")
        ing = sg.drive_ingest(srv, args)
        check(ing["restreams"] >= 1, f"no restream fired: {srv.rf_trace}")
        check(ing["rf_post_restream"] <= ing["rf_drifted"],
              f"restream left RF above the drift: {ing}")
        for swap in srv.swap_log:
            check(swap["max_load"] <= cfg.tau * swap["edges"] / K + 1,
                  f"balance cap broken after a {swap['event']}: {swap}")
        t = time.perf_counter()
        tk = srv.submit("score", program="pagerank", vertices=[0])
        srv.step()
        check(srv.result(tk).error is None, "the grown graph does not serve")
        torch.cuda.synchronize()
        grown_s = time.perf_counter() - t
        srv.tol, srv.iters = SERVE_TOL, SERVE_CAP
        with round_split(torch) as split:
            cold, warm = sg.drive_warm_cold(srv, args_tol, check=True)
        torch.cuda.synchronize()
    finally:
        del sess.run_many
    phase_s = time.perf_counter() - t_phase
    launches = {n: c for n, c in ops.launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated() / 2**30
    windows = srv.stats["windows"]
    t_want = windows + SERVE_PASSES * srv.stats["restreams"]
    log(f"[graph-serve] launches {json.dumps(launches)}")
    check(windows == SERVE_WINDOWS, f"{windows} windows flushed")
    check(set(launches) <= {"transform_scan", "ell_spmv"},
          f"the serving path launched another kernel: {launches}")
    check(launches.get("transform_scan", 0) == t_want,
          f"T launched {launches.get('transform_scan', 0)} times, not once a "
          f"flush plus {SERVE_PASSES} a restream ({t_want})")
    check(launches.get("ell_spmv", 0) == k3_expected,
          f"K3 launched {launches.get('ell_spmv', 0)} times, not once an "
          f"iteration of every pagerank run ({k3_expected})")
    for swap in srv.swap_log:
        log(f"[graph-serve] {swap['event']}: assign {swap['assign']:.4f} s "
            f"(T + prior + state on the card), RF and balance "
            f"{swap['stats']:.4f} s (host), layout rebuild "
            f"{swap['layout']:.4f} s; {swap['edges']} edges, largest load "
            f"{swap['max_load']} <= {cfg.tau * swap['edges'] / K + 1:.1f}"
            + (f"; RF before each pass {swap['trace']}" if "trace" in swap
               else ""))
    log(f"[graph-serve] RF trace {json.dumps(srv.rf_trace)}; "
        f"{srv.stats['restreams']} restreams of {SERVE_PASSES} passes; drift "
        f"{ing['rf_drifted']:.4f} repaired to {ing['rf_post_restream']:.4f}")
    log(f"[graph-serve] the grown graph ({len(sess.edges[0])} edges) served "
        f"its first query in {grown_s:.3f} s (device tables built)")
    log(f"[graph-serve] after ingestion, tol {SERVE_TOL} (cap {SERVE_CAP}): "
        f"cold {cold['iters_run']} iterations {cold['query_ms']:.3f} "
        f"ms/query, warm {warm['iters_run']} iterations {warm['query_ms']:.3f}"
        f" ms/query (per cell: cold {json.dumps(cold['cells'])}, warm "
        f"{json.dumps(warm['cells'])}); replies within L1 {sg.REPLY_L1} of "
        "direct runs")
    for name, row in split.items():
        log(f"[graph-serve] {name} round split, ms: seed tables "
            f"{row['seeds']:.3f} (host cast, upload, gather), device loop "
            f"{row['loop']:.3f}, collection {row['collect']:.3f}, the rest "
            f"{row['round'] - row['seeds'] - row['loop'] - row['collect']:.3f}"
            f" (round {row['round']:.3f})")
    log(f"[graph-serve] phase {phase_s:.1f} s; peak device memory "
        f"{peak:.2f} GiB")

    # T from seeded loads on the first flush's inputs: the window, the
    # resident partition's loads and prior, and the grown cap; then the
    # same window under the resident cap, where the partitions at the
    # balance start full
    chunks = sg.arrival_chunks(args.seed, V, SERVE_WINDOW)
    first = [next(chunks) for _ in range(4)]
    ws = torch.from_numpy(np.concatenate([c[0] for c in first])).to(dev)
    wd = torch.from_numpy(np.concatenate([c[1] for c in first])).to(dev)
    s0 = torch.from_numpy(src0.astype(np.int32)).to(dev)
    d0 = torch.from_numpy(dst0.astype(np.int32)).to(dev)
    a0 = torch.from_numpy(assign0.astype(np.int32)).to(dev)
    st = stream_state(s0, d0, a0, V, K, device=dev)
    prior = majority_vertex_map(s0, d0, a0, V, K)
    loads0 = torch.bincount(a0.long(), minlength=K)
    pu, pv, nm = ops.transform_inputs(ws.long(), wd.long(), prior, st.deg,
                                      st.divided)
    W = int(pu.shape[0])
    seeded = {}
    for name, cap in (("grown cap", cfg.tau * (E0 + W) / K),
                      ("resident cap", cfg.tau * E0 / K)):
        hcap = host_exact_cap(cap)
        got, tiers = ops.transform_scan_tiers(pu, pv, nm, K, hcap, loads0)
        t = time.perf_counter()
        exp = ops.transform_scan_plain(pu, pv, nm, K, hcap, loads0)
        plain = (time.perf_counter() - t) * 1e3
        emu, emu_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, K, hcap,
                                                         loads0)
        err = int((got.long() - exp.long()).abs().max())
        check(err == 0, f"seeded T differs from its plain walk ({name})")
        check(torch.equal(got, emu), f"seeded T differs from the tiered "
              f"emulation ({name})")
        check(tiers == emu_tiers, f"seeded T's tiers {tiers} differ from the "
              f"emulation's {emu_tiers} ({name})")
        ms = event(torch, lambda hcap=hcap: ops.transform_scan(
            pu, pv, nm, K, hcap, loads0), 5, warmup=1)
        full0 = int((loads0.double() >= cap).sum())
        fills = int(((loads0 + torch.bincount(got.long(), minlength=K))
                     .double() >= cap).sum()) - full0
        seeded[name] = dict(ms=ms, plain_ms=plain, tiers=tiers, err=err,
                            cap=cap, start_full=full0, filled=fills)
        log(f"[T-seeded] {name} {cap:.4f} (compared as {hcap:.0f}), window "
            f"{W}: bit-identical to the plain walk and the tiered emulation; "
            f"{full0} of {K} partitions full at the start, {fills} filled in "
            f"the window; tiers {json.dumps(tiers)}; {ms:.3f} ms/launch, "
            f"plain loop {plain:.0f} ms")
    g_row = seeded["grown cap"]
    nbytes, nops = W * 16 + K * 4, T_OPS_PER_EDGE * W
    bms, by = bound_ms(nbytes, nops)
    t_row.update(seeded_ms=g_row["ms"], seeded_plain_ms=g_row["plain_ms"],
                 seeded_bound_ms=bms, seeded_bound_by=by,
                 seeded_launches=launches.get("transform_scan", 0),
                 seeded_max_abs_err=g_row["err"], seeded_tiers=g_row["tiers"],
                 seeded_resident_cap=seeded["resident cap"])
    del s0, d0, a0, st, prior, pu, pv, nm, ws, wd

    # kill and resume at scale 16: the launcher's child SIGKILLs itself
    # after its snapshot; the resumed server against a freshly built one
    ck = Path(tempfile.mkdtemp(prefix="serve_ckpt_", dir=ROOT / "build"))
    try:
        args16 = argparse.Namespace(**{**vars(args), "scale": RESUME_SCALE,
                                       "window": 2048,
                                       "ckpt_dir": str(ck)})
        t = time.perf_counter()
        resumed = sg.kill_resume_check(args16)     # raises unless SIGKILL
        log(f"[graph-serve] kill/resume at scale {RESUME_SCALE}, k {K}: the "
            f"child died by SIGKILL (exit {resumed['child_returncode']}); the "
            f"resumed server has the identical config blob and assignment "
            f"and its replies agree with a freshly built server's "
            f"({time.perf_counter() - t:.1f} s)")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    return dict(query_ms=query_ms, swaps=srv.swap_log, rf_trace=srv.rf_trace,
                cold=cold, warm=warm, split=split, peak_gib=peak,
                launches=launches, seeded=seeded, phase_s=phase_s)


@contextlib.contextmanager
def round_split(torch):
    """Inside, the launcher's cold and warm rounds (its first two
    ``serve_mix`` calls) are split, synchronized, into the engine's seed
    tables, device loop and collection to the host: yields
    {"cold"|"warm": {"seeds", "loop", "collect", "round"} in ms}."""
    from repro_torch.graph import engine as eng
    from repro_torch.launch import serve_graph as sg
    split, label, order = {}, [], iter(("cold", "warm"))

    def timed(fn, part):
        def wrapped(*a, **kw):
            if not label:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[label[0]][part] += (time.perf_counter() - t) * 1e3
            return out
        return wrapped

    def serve_mix(srv, tickets):
        label[:] = [next(order)]
        split[label[0]] = dict(seeds=0.0, loop=0.0, collect=0.0, round=0.0)
        try:
            return timed(orig["serve_mix"], "round")(srv, tickets)
        finally:
            label.clear()

    orig = {"serve_mix": sg.serve_mix}
    parts = {"_warm_tables_many": "seeds", "_sim_gas_many": "loop",
             "collect_master_values": "collect"}
    for name, part in parts.items():
        orig[name] = getattr(eng, name)
        setattr(eng, name, timed(orig[name], part))
    sg.serve_mix = serve_mix
    try:
        yield split
    finally:
        sg.serve_mix = orig.pop("serve_mix")
        for name, fn in orig.items():
            setattr(eng, name, fn)


def sweep_phase(torch, ops, g, main_assign) -> dict:
    """``[sweep]``: ``partition_sweep`` over ``SWEEP_KS`` on the scale-20
    stream with the main path's profile at each k; the k = K entry must
    equal phase 2's partition edge for edge, every k's RF must be below a
    random assignment's and its largest partition within τ·E/k + 1."""
    import numpy as np
    from repro_torch.core import CLUGPConfig, metrics, partition_sweep
    E, V = g.num_edges, g.num_vertices
    cfg = CLUGPConfig.optimized(K, restream=1)
    t = time.perf_counter()
    res = partition_sweep(g.src, g.dst, V, cfg, SWEEP_KS)
    total = time.perf_counter() - t
    out = {}
    for k, r in zip(SWEEP_KS, res):
        st = r.stats
        sec = st["stage_seconds"]
        rf_random = metrics.replication_factor(
            g.src, g.dst, np.random.default_rng(0).integers(0, k, E)
            .astype(np.int32), V, k)
        log(f"[sweep] k={k}: rf {st['rf']:.4f} (random {rf_random:.4f}), "
            f"balance {st['balance']:.4f}, clusters {st['num_clusters']}, "
            f"game rounds {st['game_rounds']}; seconds "
            + json.dumps({n: round(v, 4) for n, v in sec.items()})
            + f"; {sum(sec.values()) * 1e6 / E:.4f} us/edge")
        check(st["rf"] < rf_random, f"sweep k={k}: RF not below random")
        check(max(st["sizes"]) <= cfg.tau * E / k + 1,
              f"sweep k={k}: balance cap broken")
        out[k] = dict(rf=st["rf"], balance=st["balance"],
                      rounds=st["game_rounds"], seconds=sec)
    main = res[SWEEP_KS.index(K)]
    differ = int((main.assign != main_assign).sum())
    check(differ == 0, f"sweep k={K} differs from phase 2's partition in "
          f"{differ} edges")
    log(f"[sweep] ks {SWEEP_KS} in {total:.3f} s (m_cap {main.stats['m_cap']},"
        f" cap retries {main.stats['cap_retries']}); k={K} equals phase 2's "
        f"partition edge for edge")
    return out


def scan_phase(torch, ops, sm_hz) -> dict:
    """``[scan]``: ``kernel="scan"`` at ``SCAN_SCALE`` (scale 16 if the
    graph's m_cap passes the pair-key limit).  Counts zeroed before the
    card partition and read after: K1, G and T launched, G once a round,
    no other kernel.  G against ``game_gs_plain`` bit for bit on the
    first round's inputs, timed; the whole scan partition on the card
    against the port on the CPU from the same start assignment, edge for
    edge; the Jacobi CSR game's stage seconds on the same graph beside.
    Returns G's kernel row."""
    import numpy as np
    from repro_torch.core import CLUGPConfig, partition, web_graph
    from repro_torch.core.game import PAIR_KEY_LIMIT, cluster_pairs
    from repro_torch.core.stages import (cluster_graph_arrays,
                                         lambda_from_totals)
    dev = torch.device("cuda")
    for scale in (SCAN_SCALE, SCAN_SCALE - 1):
        g = web_graph(scale=scale, edge_factor=EDGE_FACTOR, seed=0)
        off = partition(g.src, g.dst, g.num_vertices,
                        CLUGPConfig.optimized(K, game=False))
        m_cap = off.stats["m_cap"]
        if m_cap * (m_cap + 1) < PAIR_KEY_LIMIT:
            break
        log(f"[scan] scale {scale}: m_cap {m_cap} passes the pair-key "
            f"limit (the scan falls back); using scale {scale - 1}")
    E, V = g.num_edges, g.num_vertices
    cfg = CLUGPConfig.optimized(K, restream=1, kernel="scan")
    start = torch.from_numpy(np.random.default_rng(0).integers(
        0, K, m_cap).astype(np.int32))
    ops.reset_launch_counts()
    t = time.perf_counter()
    card = partition(g.src, g.dst, V, cfg, assign0=start)
    t_card = time.perf_counter() - t
    launches = ops.launch_counts()
    log(f"[scan] launches {json.dumps(launches)}")
    check_path_launches(ops, launches, "scan")
    rounds = card.game_rounds
    check(launches["game_gs"] == rounds, f"G launched {launches['game_gs']} "
          f"times in {rounds} rounds, not once a round")
    check(launches["cluster_scatter"] == 1 + card.stats["cap_retries"],
          "K1 not once per clustering pass")
    jac = partition(g.src, g.dst, V, CLUGPConfig.optimized(K, restream=1))
    t = time.perf_counter()
    cpu = partition(g.src, g.dst, V, cfg, device="cpu", assign0=start)
    t_cpu = time.perf_counter() - t
    differ = int((cpu.assign != card.assign).sum())
    check(cpu.game_rounds == rounds and differ == 0,
          f"scan partition: card and CPU differ ({rounds} vs "
          f"{cpu.game_rounds} rounds, {differ} edges)")
    st = card.stats
    log(f"[scan] scale {scale}: V={V} E={E}, clusters {st['num_clusters']}, "
        f"m_cap {m_cap}; rf {st['rf']:.4f}, balance {st['balance']:.4f}, "
        f"{rounds} rounds, G launches {launches['game_gs']}; game "
        f"{st['stage_seconds']['game']:.4f} s (Jacobi CSR game on the same "
        f"graph {jac.stats['stage_seconds']['game']:.4f} s, {jac.game_rounds} "
        f"rounds, rf {jac.stats['rf']:.4f}); partition {t_card:.3f} s; "
        f"equals the CPU port's edge for edge ({t_cpu:.1f} s on the CPU, "
        f"game {cpu.stats['stage_seconds']['game']:.2f} s)")
    g_in_game = game_gs_in_partition(torch, lambda: partition(
        g.src, g.dst, V, cfg, assign0=start))
    log(f"[scan] G inside the partition (profiler, a second card run from "
        f"the same start): {g_in_game['launches']} launches seen, "
        f"{g_in_game['ms']:.4f} ms of device time = "
        f"{100 * g_in_game['ms'] / 1e3 / st['stage_seconds']['game']:.1f}% "
        f"of the unprofiled run's game stage "
        f"({g_in_game['game_s']:.4f} s under the profiler)")

    # G on the first round's inputs: the card run's cluster graph and the
    # injected start
    src_t = torch.from_numpy(g.src).to(dev)
    dst_t = torch.from_numpy(g.dst).to(dev)
    gs = cluster_graph_arrays(src_t, dst_t,
                              torch.from_numpy(card.clustering.clu).to(dev),
                              m_cap, cfg.effective_sizes)
    row, col, w = cluster_pairs(gs.xs, gs.xd, m_cap)
    lam = lambda_from_totals(gs.sizes.sum(), gs.n_cross, K,
                             cfg.relative_weight).reshape(1)
    a0 = start.to(dev)
    aff = torch.zeros(m_cap, K, device=dev).index_put_(
        (row, a0[col].long()), w, accumulate=True)
    loads = torch.zeros(K, device=dev).index_add_(0, a0.long(), gs.sizes)
    n = int(torch.nonzero((gs.sizes != 0) | (gs.row_tot != 0)).max()) + 1
    args = (aff, gs.sizes, gs.row_tot, a0, loads)
    got = ops.game_gs(*args, lam=lam, k=K, n=n)
    t = time.perf_counter()
    want = ops.game_gs_plain(*args, lam=lam, k=K, n=n)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t) * 1e3
    for name, a_, b_ in zip(("assign", "loads", "moved"), got, want):
        check(torch.equal(a_.to(b_.dtype), b_),
              f"G differs from its plain version in {name}")
    full = ops.game_gs(*args, lam=lam, k=K)
    check(all(torch.equal(a_, b_) for a_, b_ in zip(full, got)),
          "G over every row differs from G over the live prefix")
    ms = event_ms(torch, lambda: ops.game_gs(*args, lam=lam, k=K, n=n), 10)
    # each live row's cut-mass row, size, row total and assignment read,
    # its assignment written; the loads read and written; λ; the count
    nbytes = n * K * 4 + 16 * n + 8 * K + 8
    bms, by = bound_ms(nbytes, K2_OPS_PER_LANE * n * K)
    lat = latency_ms(n, G_STEPS_PER_CLUSTER, sm_hz)
    log(f"[G] k={K}, {n} live rows of m_cap {m_cap}: bit-identical to the "
        f"plain sweep on the first round's inputs ({int(got[2])} moves); "
        f"{ms:.4f} ms/sweep = {ms * 1e3 / n:.4f} us/cluster, plain "
        f"{plain:.1f} ms; bound {bms:.5f} ms ({by}), latency floor "
        f"{lat:.4f} ms ({n} clusters x {G_STEPS_PER_CLUSTER} dependent "
        f"steps x {SMEM_STEP_CYCLES} cycles); {rounds} sweeps a partition x "
        f"this first-round sweep = {rounds * ms:.2f} ms; the profiled "
        f"partition's own G time {g_in_game['ms']:.2f} ms of the game's "
        f"{st['stage_seconds']['game'] * 1e3:.1f}")
    return dict(name="game_gs", route="cuda",
                source="src/repro_torch/csrc/game_gs.cu",
                replaces="src/repro/core/game.py:428",
                launches=launches["game_gs"], max_abs_err=0.0, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                latency_bound_ms=lat, limited_by="latency", rows=n,
                m_cap=m_cap, sweeps_per_partition=rounds, scale=scale,
                ms_in_partition=g_in_game["ms"])


def partition_cli_phase(torch) -> dict:
    """``[partition-cli]`` at ``CLI_SCALE``, k = K: the np backend beside
    the torch backend, the np host combine over 4 nodes, the five
    baselines, then the partition launcher as a subprocess (``--backend
    jit --pagerank``), which must exit 0 and print the reference's
    lines."""
    import os
    import numpy as np
    from repro_torch.core import (CLUGPConfig, baselines, metrics, partition,
                                  random_stream, web_graph)
    g = web_graph(scale=CLI_SCALE, edge_factor=EDGE_FACTOR, seed=0)
    E, V = g.num_edges, g.num_vertices
    cfg = CLUGPConfig.optimized(K, restream=1)
    out = {}
    for label, kw in (("np", dict(backend="np", nodes=1)),
                      ("np, 4 nodes", dict(backend="np", nodes=4)),
                      ("torch", dict(backend="torch", nodes=1))):
        t = time.perf_counter()
        r = partition(g.src, g.dst, V, cfg, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        out[label] = dict(rf=r.stats["rf"], seconds=sec)
        extra = (f"; per node {json.dumps(r.stats['per_node'])}"
                 if "per_node" in r.stats else
                 f"; stages " + json.dumps({n: round(v, 4) for n, v in
                                            r.stats["stage_seconds"].items()}))
        log(f"[partition-cli] scale {CLI_SCALE} V={V} E={E} k={K} {label}: rf "
            f"{r.stats['rf']:.4f}, balance {r.stats['balance']:.4f}, rounds "
            f"{r.stats['game_rounds']}, {sec:.3f} s{extra}")
        # each node's slice holds its own cap τ·E_s/k, one edge over at most
        check(max(r.stats["sizes"]) <= cfg.tau * E / K + kw["nodes"],
              f"{label}: balance cap broken")
    gr = random_stream(g, seed=0)
    for name, fn in baselines.ALL_BASELINES.items():
        t = time.perf_counter()
        a = fn(gr.src, gr.dst, V, K)
        sec = time.perf_counter() - t
        rf = metrics.replication_factor(gr.src, gr.dst, a, V, K)
        out[name] = dict(rf=rf, seconds=sec)
        log(f"[partition-cli] baseline {name}: rf {rf:.4f}, balance "
            f"{metrics.load_balance(a, K):.4f}, {sec:.3f} s on the host")
    cmd = [sys.executable, "-m", "repro_torch.launch.partition", "--scale",
           str(CLI_SCALE), "--k", str(K), "--algo", "clugp-opt",
           "--backend", "jit", "--pagerank"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    sec = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    for ln in lines:
        log(f"[partition-cli] launcher: {ln}")
    check(proc.returncode == 0, f"the launcher exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    want = ("graph: V=", "clugp-opt[jit, restream=0]: rf=",
            "interior/frontier: frac=", "pagerank[halo]: ")
    check(len(lines) == len(want) and all(
        ln.startswith(p) for ln, p in zip(lines, want)),
        f"the launcher's lines are not the reference's: {lines}")
    err = float(lines[-1].split("max|err|=")[1].split()[0])
    check(err < 1e-6, f"the launcher's pagerank max|err| {err}")
    log(f"[partition-cli] launcher subprocess {sec:.1f} s")
    out["launcher_seconds"] = sec
    return out


def ssd_flops(cfg, B, S) -> int:
    """Operations of one SSD sublayer (``mamba.ssd_apply``) on B × S
    tokens from the shapes the code runs: the four input projections (x
    and z to d_inner, B and C to 2·N, dt to the heads) and ``out_proj``,
    then the chunked einsums — the chunk scores C·Bᵀ (chunk² · N a
    chunk), ``y_intra`` over every (t, s) pair of a chunk (the product
    runs over the masked triangle too), the chunk states and ``y_inter``
    (N · d_inner a token each).  A multiply-add counts two."""
    s = cfg.ssm
    d, di, N, c = cfg.d_model, s.expand * cfg.d_model, s.d_state, s.chunk
    proj = d * (2 * di + 2 * N + di // s.head_dim) + di * d
    return 2 * B * S * (proj + c * N + c * di + 2 * N * di)


def prefill_flops(cfg, B, S, capacity, Sm=0) -> int:
    """Operations of one prefill of B × S positions (a vlm's prefix
    positions included) as the code runs it: per attention layer the
    projections (GQA's q, k, v, o; MLA's q_a, q_b, kv_a, kv_b, o), causal
    attention over the unmasked (q, k) pairs (a multiply-add per q·k
    column and per p·v column), then the layer's FFN: a dense layer's
    three matrices (two, ungated, under layernorm), or an MoE layer's
    shared expert, routed bank at its capacity-padded E × C slots a group
    and router; an SSD layer (``ssd_flops``), and a hybrid period's
    sublayers, each attention or SSD and then its FFN; an encoder layer
    over B × Sm source frames (non-causal: Sm · Sm pairs) and a decoder
    layer's cross-attention (q and o over the tokens, k and v over the
    memory, S · Sm pairs); then the LM head at the last position.  A
    multiply-add counts two."""
    from repro_torch.models import layer_groups
    d, H, N = cfg.d_model, cfg.n_heads, B * S
    pairs = B * H * (S * (S + 1) // 2)
    if cfg.mla is not None:
        m = cfg.mla
        proj = 2 * N * (d * m.q_lora + m.q_lora * H * (m.nope_dim + m.rope_dim)
                        + d * (m.kv_lora + m.rope_dim)
                        + m.kv_lora * H * (m.nope_dim + m.v_dim)
                        + H * m.v_dim * d)
        attn = proj + 2 * (m.nope_dim + m.rope_dim + m.v_dim) * pairs
    else:
        proj = 2 * N * d * 2 * (H + cfg.n_kv_heads) * cfg.hd
        attn = proj + 4 * cfg.hd * pairs
    mats = 3 if cfg.norm == "rmsnorm" else 2       # gated or not
    ffn = {"dense": 2 * N * mats * d * cfg.d_ff}
    if cfg.moe is not None:
        mo = cfg.moe
        expert = 3 * d * mo.d_expert        # multiply-adds a token an expert
        ffn["moe"] = (2 * N * mo.n_shared * expert
                      + 2 * B * mo.n_experts * capacity * expert
                      + 2 * N * d * mo.n_experts)
    ssd = ssd_flops(cfg, B, S) if cfg.ssm is not None else 0
    layer = {"dense": attn + ffn["dense"], "moe": attn + ffn.get("moe", 0),
             "ssd": ssd}
    if cfg.family == "hybrid":
        layer["hyb"] = sum(
            (attn if i == cfg.attn_index else ssd)
            + ffn["moe" if cfg.moe and i % cfg.moe.every == 1 else "dense"]
            for i in range(cfg.attn_period))
    if cfg.family == "encdec":
        Nm, hd, kv = B * Sm, cfg.hd, cfg.n_kv_heads
        layer["enc"] = (2 * Nm * d * 2 * (H + kv) * hd + 4 * hd * B * H * Sm
                        * Sm + 2 * Nm * mats * d * cfg.d_ff)
        layer["dec"] = (attn + 2 * N * d * 2 * H * hd + 2 * Nm * d * 2 * kv
                        * hd + 4 * hd * B * H * S * Sm + ffn["dense"])
    head = 2 * B * d * cfg.padded_vocab
    return head + sum(count * layer[group]
                      for group, count in layer_groups(cfg))


def attention_calls(cfg) -> list:
    """(q/k head dim, v head dim, causal, Sq, Skv) of every call of K4 in
    one forward of ``cfg`` on positions S over Sm source frames (``S``,
    ``Sm`` standing for them): a dense or MoE layer's self-attention, a
    hybrid period's one, an encoder layer's over the frames (not causal),
    a decoder layer's self-attention and its cross-attention over the
    frames (not causal); none in an SSM model."""
    from repro_torch.models import layer_groups
    D = cfg.mla.nope_dim + cfg.mla.rope_dim if cfg.mla else cfg.hd
    Dv = cfg.mla.v_dim if cfg.mla else cfg.hd
    per = {"dense": [(D, Dv, True, "S", "S")], "moe": [(D, Dv, True, "S", "S")],
           "hyb": [(D, Dv, True, "S", "S")], "ssd": [],
           "enc": [(D, Dv, False, "Sm", "Sm")],
           "dec": [(D, Dv, True, "S", "S"), (D, Dv, False, "S", "Sm")]}
    return [c for group, count in layer_groups(cfg)
            for c in per[group] * count]


def train_flops(cfg, B, S, capacity=0, Sm=0) -> int:
    """Operations of one training step of B × S positions (over B × Sm
    source frames for an encoder–decoder; ``capacity`` an MoE layer's
    slots an expert a row) as the code runs it: the forward as
    ``prefill_flops`` counts it, with the LM head at every position, runs
    once, again in the remat recompute (each layer's checkpoint, and each
    CE chunk's) and twice over in the backward (the input's and the
    weight's gradients) — 4× the forward; K4's backward recomputes S, so
    an unmasked (q, k) pair costs 2·(3·Dqk + 2·Dv) there against the
    forward's 2·(Dqk + Dv), 2·Dqk above 4×.  For a dense model: 8 a
    weight a token and 18·D a pair.  The embedding is a gather: no
    operations.  A multiply-add counts two."""
    head = 2 * B * cfg.d_model * cfg.padded_vocab
    fwd = prefill_flops(cfg, B, S, capacity, Sm) - head
    n = {"S": S, "Sm": Sm}
    extra = 0
    for D, _Dv, causal, sq, skv in attention_calls(cfg):
        pairs = B * cfg.n_heads * (n[sq] * (n[sq] + 1) // 2 if causal
                                   else n[sq] * n[skv])
        extra += 2 * D * pairs
    return 4 * fwd + extra + 4 * head * S


@contextlib.contextmanager
def spy(*targets):
    """For each (module, name, record): calls ``record(args, kw)`` with
    every call of ``module.name`` while the block runs (the models call
    ``moe.moe_apply``, ``mamba.ssd_apply``, ``mamba.ssd_chunked`` and
    ``lm._self_attention`` through their modules)."""
    reals = [(module, name, getattr(module, name))
             for module, name, _ in targets]
    for (module, name, real), (*_, record) in zip(reals, targets):
        def wrapped(*args, _real=real, _record=record, **kw):
            _record(args, kw)
            return _real(*args, **kw)
        setattr(module, name, wrapped)
    try:
        yield
    finally:
        for module, name, real in reals:
            setattr(module, name, real)


def routing_recorder(torch, M, mo, capacity, routing):
    """A ``record`` for ``spy`` on ``moe_apply``: appends each MoE layer's
    (kept pairs, routed pairs, expert load) at ``capacity`` to
    ``routing``."""
    def record(args, kw):
        p, x = args
        top_idx, gates = M.route(p, x, top_k=kw["top_k"],
                                 router_softmax_after_topk=kw[
                                     "router_softmax_after_topk"])
        tok, _ = M.dispatch_tables(top_idx, gates, n_experts=mo.n_experts,
                                   capacity=capacity)
        routing.append((int((tok < x.shape[1]).sum()), top_idx.numel(),
                        torch.bincount(top_idx.reshape(-1),
                                       minlength=mo.n_experts).cpu()))
    return record


def timed_prefill(torch, ops, prefill_step, params, batch, watch, k4,
                  vocab, tag):
    """A warm-up prefill of ``batch`` inside ``watch`` (a ``spy`` that
    records what the phase reads), then one with the counts zeroed before
    and read after: K4 exactly ``k4`` times (once an attention) and no
    other kernel, or no kernel at all where ``k4`` is 0; logits (B, 1,
    vocab), finite.  Returns (the timed prefill's seconds, its launches,
    its peak memory in GiB)."""
    with watch:
        prefill_step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    logits = prefill_step(params, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = ops.launch_counts()
    log(f"[{tag}] prefill launches {json.dumps(launches)}")
    if k4:
        check_path_launches(ops, launches, "lm")
    check(launches.get("flash_attention", 0) == k4 and sum(
        launches.values()) == k4, f"the {tag} prefill launched {launches}, "
          f"not K4 once an attention layer ({k4})")
    check(logits.shape == (batch["tokens"].shape[0], 1, vocab)
          and bool(torch.isfinite(logits).all()), f"{tag} prefill logits")
    return seconds, launches, torch.cuda.max_memory_allocated() / 2**30


def routing_summary(routing, capacity, group, first):
    """The drop share over the MoE layers and layer ``first``'s load."""
    kept = sum(r[0] for r in routing)
    routed = sum(r[1] for r in routing)
    load = routing[0][2].double()
    return (f"capacity {capacity} slots an expert a group of {group}; "
            f"dropped {1 - kept / routed:.4%} of {routed} routed pairs over "
            f"the {len(routing)} MoE layers (per layer "
            + ", ".join(f"{1 - k / r:.4f}" for k, r, _ in routing)
            + f"); layer {first}'s expert load max/mean "
            f"{float(load.max() / load.mean()):.3f} ({int(load.min())} to "
            f"{int(load.max())} pairs an expert)")


def timed_decode(torch, ops, generate, params, cfg, prompt, new_tokens,
                 tag, memory=None, k4_step=0):
    """``generate`` (an encdec model's steps attending ``memory``) after a
    short warm-up, with the counts zeroed before: K4 exactly ``k4_step``
    times a step (an encdec model's cross-attentions) and no other
    kernel, every logit finite, tokens in the vocabulary.  Returns the
    ``Generation`` and its launches."""
    generate(params, cfg, prompt[:, :2], 2, dtype=torch.bfloat16,
             memory=memory)
    ops.reset_launch_counts()
    served = generate(params, cfg, prompt, new_tokens, dtype=torch.bfloat16,
                      memory=memory)
    launches = ops.launch_counts()
    want = k4_step * served.steps
    check(launches.get("flash_attention", 0) == want
          and sum(launches.values()) == want, f"{tag} decode launched "
          f"{launches}, not K4 {k4_step} times a step")
    check(served.finite and served.tokens.shape == (prompt.shape[0],
                                                    new_tokens)
          and int(served.tokens.max()) < cfg.vocab, f"{tag} decode output")
    return served, launches


def moe_phase(torch, ops, dev, k4_row) -> None:
    """``[moe]``: llama4-scout (16 experts top-1 + a shared expert, GQA
    40/8) at published width and 12 of its 48 layers, bf16, seeded.  The
    parameter count against ``param_count``; ``make_prefill_step`` on 4 ×
    2,048 tokens with the counts zeroed before and read after (K4 once a
    layer, no other kernel), tokens/s beside the FLOP ceiling, the drop
    share and one layer's expert load; ``generate`` (no K4), ms/token-step
    beside the weight-read floor, every logit finite.  Then the same model
    cut to 2 layers in f32 at a capacity that drops nothing: prefill (K4)
    against the decode loop within 2e-3, and ``moe_apply`` against
    ``moe_reference`` on layer 0's real input within 2e-4.  Last, K4 at
    the group-5 prefill shape against its plain version (2e-2), timed
    beside its bound and SDPA; its launches join K4's row."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, param_count, prefill, \
        tree_leaves
    from repro_torch.models import moe as M
    from repro_torch.train import make_prefill_step

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    mo = cfg.moe
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg), f"parameter count {n_params} != "
          f"param_count {param_count(cfg)}")
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    # a decode step reads every weight but the embedding table (B rows)
    step_bytes = weight_bytes - params["embed"]["table"].numel() * 2
    log(f"[moe] {cfg.name}: {MOE_LAYERS} of {full.n_layers} layers "
        f"(reduced: n_layers), d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, {mo.n_experts} experts top-{mo.top_k} "
        f"d_expert {mo.d_expert} + {mo.n_shared} shared, vocab {cfg.vocab}: "
        f"{n_params} parameters = param_count ({weight_bytes / 1e9:.3f} GB "
        f"bf16) built in {time.perf_counter() - t:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    capacity = M.expert_capacity(PREFILL_S, mo.top_k, mo.n_experts,
                                 mo.capacity_factor)
    routing = []
    t_prefill, launches, peak = timed_prefill(
        torch, ops, make_prefill_step(cfg, dtype=torch.bfloat16), params,
        {"tokens": tokens}, spy((M, "moe_apply", routing_recorder(
            torch, M, mo, capacity, routing))), MOE_LAYERS,
        cfg.padded_vocab, "moe")
    flops = prefill_flops(cfg, PREFILL_B, PREFILL_S, capacity)
    ceiling = flops / BF16_OPS_PER_S
    log(f"[moe] prefill B={PREFILL_B} S={PREFILL_S}: {t_prefill * 1e3:.3f} "
        f"ms = {PREFILL_B * PREFILL_S / t_prefill:.1f} tokens/s (ceiling "
        f"{flops:.4e} FLOP at 989 TFLOP/s = {ceiling * 1e3:.3f} ms = "
        f"{PREFILL_B * PREFILL_S / ceiling:.1f} tokens/s; "
        f"{flops / t_prefill / 1e12:.1f} TFLOP/s); peak device memory "
        f"{peak:.2f} GiB")
    check(len(routing) == MOE_LAYERS, f"{len(routing)} MoE layers ran")
    log("[moe] routing: " + routing_summary(routing, capacity, PREFILL_S, 0))
    del routing

    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    served, _ = timed_decode(torch, ops, generate, params, cfg, prompt,
                             MOE_TOKENS, "MoE")
    ms_step = served.seconds * 1e3 / served.steps
    log(f"[moe] decode B={SERVE_B}, prompt {SERVE_PROMPT} + {MOE_TOKENS} "
        f"tokens: {served.steps} steps in {served.seconds:.3f} s = "
        f"{ms_step:.3f} ms/token-step (floor: {step_bytes / 1e9:.3f} GB of "
        f"weights per step, every expert at capacity 1, at 3.35 TB/s = "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); logits finite; "
        f"first tokens {served.tokens[0][:16].tolist()}")
    del params, served
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 cross-check at a capacity that drops nothing (E / k slots a
    # token): a prefill group and a one-token decode step drop differently
    # otherwise, as the JAX package's own decode-vs-forward test says
    small = dataclasses.replace(full, n_layers=CHECK_LAYERS,
                                moe=dataclasses.replace(
                                    mo, capacity_factor=mo.n_experts
                                    / mo.top_k))
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (CHECK_B, CHECK_PROMPT))).to(dev)
    inputs = []
    ops.reset_launch_counts()
    with spy((M, "moe_apply", lambda a, kw: inputs.append((*a, kw)))):
        pre, _ = prefill(p32, {"tokens": prompt}, small, dtype=torch.float32)
    check(ops.launch_counts().get("flash_attention") == CHECK_LAYERS,
          "the f32 MoE prefill did not run on K4")
    dec = generate(p32, small, prompt, 1, dtype=torch.float32)
    check(dec.finite, "f32 MoE decode logits not finite")
    torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                               atol=2e-3)
    p0, x0, kw = inputs[0]
    got = M.moe_apply(p0, x0, **kw)
    want = M.moe_reference(p0, x0, n_experts=kw["n_experts"],
                           top_k=kw["top_k"])
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    log(f"[moe] check: {CHECK_LAYERS} layers at full width, f32, "
        f"B={CHECK_B}, prompt {CHECK_PROMPT}, capacity factor "
        f"{kw['capacity_factor']}: prefill (K4) vs decode loop last logits "
        f"max |d| {float((dec.prompt_logits - pre[:, -1]).abs().max()):.3e} "
        f"(tolerance 2e-3); moe_apply vs moe_reference on layer 0's input "
        f"{tuple(x0.shape)} max |d| {float((got - want).abs().max()):.3e} "
        f"(tolerance 2e-4)")
    del p32, pre, dec, inputs, p0, x0, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # K4 at the MoE prefill's shape: 40 query heads over 8 KV heads
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(PREFILL_B, Hq, PREFILL_S, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(PREFILL_B, Hkv, PREFILL_S, D, generator=gen,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = float((got.float() - want.float()).abs().max())
    ms = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                  20)
    plain = event_ms(torch, lambda: ops.flash_attention_plain(
        q, k, v, causal=True), 3, warmup=1)
    lib = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    k4_flops = 4 * D * (PREFILL_S * (PREFILL_S + 1) // 2) * PREFILL_B * Hq
    bms, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), k4_flops,
                       BF16_OPS_PER_S)
    group7 = k4_flops * 28 / Hq / k4_row["ms"] / 1e9   # the row's shape
    log(f"[moe] K4 bf16 q {tuple(q.shape)} k/v {tuple(k.shape)} causal "
        f"(group {Hq // Hkv}): max |d| {err:.3e}; {ms:.4f} ms/launch = "
        f"{k4_flops / ms / 1e9:.1f} TFLOP/s (group 7 at 28/4: {group7:.1f}); "
        f"bound {bms:.4f} ms ({by}); plain {plain:.3f} ms; "
        f"scaled_dot_product_attention {lib:.4f} ms; {MOE_LAYERS} launches = "
        f"{MOE_LAYERS * ms / (t_prefill * 1e3):.1%} of the prefill")
    k4_row["launches"] += launches["flash_attention"]
    del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")


def mla_phase(torch, ops, dev) -> dict:
    """``[mla]``: deepseek-v3 (MLA: 128 heads, q_lora 1,536, kv_lora 512,
    nope 128, rope 64, v 128; 256 experts top-8 + a shared expert after 3
    dense layers) at published width and 5 of its 61 layers, bf16,
    seeded.  The parameter count against ``param_count``;
    ``make_prefill_step`` on 4 × 2,048 tokens with the counts zeroed
    before and read after (K4 once a layer at (192, 128), no other
    kernel; the profiler's count of K4 launches in a second prefill),
    tokens/s and TFLOP/s beside the FLOP ceiling, peak memory, the drop
    share and the first MoE layer's load; ``generate`` (no K4; the latent
    cache), ms/token-step beside the weight-read floor, every logit
    finite.  Then 2 dense layers at full width in f32 (the MoE left out:
    its bank would be 46 GB in f32): the decompressed prefill (K4's f32
    path at 192/128) against the absorbed decode loop within 2e-3.  Last,
    K4 at the prefill's shape as the model passes it (transposed views, v
    a slice of kv_b's rows) against its plain version in bf16 (p rounded
    as the kernel rounds it; 2e-2) and in f32 (2e-5), timed beside its
    bound and ``scaled_dot_product_attention`` (each fused backend tried
    alone; a refusal is logged).  Returns K4's row at this shape."""
    import dataclasses
    import math

    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, param_count, prefill, \
        tree_leaves
    from repro_torch.models import moe as M
    from repro_torch.train import make_prefill_step

    log(f"[mla] before the phase: {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated ([moe]'s weights freed); the peak since [moe]'s "
        f"last reset {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=MLA_LAYERS)
    mo, m = cfg.moe, cfg.mla
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg) == MLA_PARAMS, f"parameter count "
          f"{n_params}, param_count {param_count(cfg)}, want {MLA_PARAMS}")
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    # a decode step reads every weight but the embedding table (B rows)
    step_bytes = weight_bytes - params["embed"]["table"].numel() * 2
    log(f"[mla] {cfg.name}: {MLA_LAYERS} of {full.n_layers} layers "
        f"(reduced: n_layers; {mo.first_k_dense} dense, "
        f"{MLA_LAYERS - mo.first_k_dense} MoE), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, MLA q_lora {m.q_lora} kv_lora {m.kv_lora} "
        f"nope {m.nope_dim} rope {m.rope_dim} v {m.v_dim}, d_ff {cfg.d_ff}, "
        f"{mo.n_experts} experts top-{mo.top_k} d_expert {mo.d_expert} + "
        f"{mo.n_shared} shared, vocab {cfg.vocab}: {n_params} parameters = "
        f"param_count ({weight_bytes / 1e9:.3f} GB = "
        f"{weight_bytes / 2**30:.2f} GiB bf16) built in "
        f"{time.perf_counter() - t:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    capacity = M.expert_capacity(PREFILL_S, mo.top_k, mo.n_experts,
                                 mo.capacity_factor)
    routing = []
    prefill_step = make_prefill_step(cfg, dtype=torch.bfloat16)
    t_prefill, launches, peak = timed_prefill(
        torch, ops, prefill_step, params, {"tokens": tokens},
        spy((M, "moe_apply",
             routing_recorder(torch, M, mo, capacity, routing))), MLA_LAYERS,
        cfg.padded_vocab, "mla")
    with warnings.catch_warnings():      # the profiler's one-cycle notice
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            prefill_step(params, {"tokens": tokens})
            torch.cuda.synchronize()
    k4_seen = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "flash_bf16_kernel" in e.name]
    flops = prefill_flops(cfg, PREFILL_B, PREFILL_S, capacity)
    ceiling = flops / BF16_OPS_PER_S
    log(f"[mla] prefill B={PREFILL_B} S={PREFILL_S}: {t_prefill * 1e3:.3f} "
        f"ms = {PREFILL_B * PREFILL_S / t_prefill:.1f} tokens/s (ceiling "
        f"{flops:.4e} FLOP at 989 TFLOP/s = {ceiling * 1e3:.3f} ms = "
        f"{PREFILL_B * PREFILL_S / ceiling:.1f} tokens/s; "
        f"{flops / t_prefill / 1e12:.1f} TFLOP/s = {ceiling / t_prefill:.1%} "
        f"of the ceiling); the profiler saw {len(k4_seen)} K4 launches "
        f"({', '.join(f'{u / 1e3:.4f}' for u in k4_seen)} ms); peak device "
        f"memory {peak:.2f} GiB")
    check(len(routing) == MLA_LAYERS - mo.first_k_dense,
          f"{len(routing)} MoE layers ran")
    log("[mla] routing: " + routing_summary(routing, capacity, PREFILL_S,
                                            mo.first_k_dense))
    del routing, prof

    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    served, _ = timed_decode(torch, ops, generate, params, cfg, prompt,
                             MOE_TOKENS, "MLA")
    ms_step = served.seconds * 1e3 / served.steps
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[mla] decode B={SERVE_B}, prompt {SERVE_PROMPT} + {MOE_TOKENS} "
        f"tokens from the latent cache: {served.steps} steps in "
        f"{served.seconds:.3f} s = {ms_step:.3f} ms/token-step (floor: "
        f"{step_bytes / 1e9:.3f} GB of weights per step, every expert at "
        f"capacity 1, at 3.35 TB/s = {floor_ms:.3f} ms, "
        f"{floor_ms / ms_step:.1%} of the step); logits finite; first "
        f"tokens {served.tokens[0][:16].tolist()}")
    del params, served
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 check: 2 dense layers at full width (moe=None gives one
    # dense group in both packages; n_layers 2 under first_k_dense 3 would
    # give an moe group of -1 layers), the decompressed prefill on K4's
    # f32 path against the absorbed decode loop
    small = dataclasses.replace(full, n_layers=CHECK_LAYERS, moe=None)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (CHECK_B, CHECK_PROMPT))).to(dev)
    ops.reset_launch_counts()
    pre, _ = prefill(p32, {"tokens": prompt}, small, dtype=torch.float32)
    check(ops.launch_counts().get("flash_attention") == CHECK_LAYERS,
          "the f32 MLA prefill did not run on K4")
    dec = generate(p32, small, prompt, 1, dtype=torch.float32)
    check(dec.finite, "f32 MLA decode logits not finite")
    torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                               atol=2e-3)
    log(f"[mla] check: {CHECK_LAYERS} dense layers at full width, f32, "
        f"B={CHECK_B}, prompt {CHECK_PROMPT}: decompressed prefill (K4 f32 "
        f"at 192/128) vs absorbed decode loop last logits max |d| "
        f"{float((dec.prompt_logits - pre[:, -1]).abs().max()):.3e} "
        f"(tolerance 2e-3)")
    del p32, pre, dec
    gc.collect()
    torch.cuda.empty_cache()

    # K4 at the prefill's shape, laid out as mla_attention passes it
    H, Dqk, Dv = cfg.n_heads, m.nope_dim + m.rope_dim, m.v_dim
    scale = 1.0 / math.sqrt(Dqk)
    gen = torch.Generator(device=dev).manual_seed(6)

    def qkv(B, S, dtype):
        q, k = (torch.randn(B, S, H, Dqk, generator=gen, device=dev,
                            dtype=dtype).transpose(1, 2) for _ in range(2))
        kvb = torch.randn(B, S, H, m.nope_dim + Dv, generator=gen,
                          device=dev, dtype=dtype)
        return q, k, kvb[..., m.nope_dim:].transpose(1, 2)

    q, k, v = qkv(CHECK_B, F32_S, torch.float32)
    got = ops.flash_attention(q, k, v, causal=True, sm_scale=scale)
    want = ops.flash_attention_plain(q, k, v, causal=True, sm_scale=scale)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    err32 = float((got - want).abs().max())
    del q, k, v, got, want
    q, k, v = qkv(PREFILL_B, PREFILL_S, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True, sm_scale=scale)
    want = ops.flash_attention_plain(q, k, v, causal=True, sm_scale=scale,
                                     block_kv=128, p_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = float((got.float() - want.float()).abs().max())
    ms = event_ms(torch, lambda: ops.flash_attention(
        q, k, v, causal=True, sm_scale=scale), 20)
    plain = event_ms(torch, lambda: ops.flash_attention_plain(
        q, k, v, causal=True, sm_scale=scale), 3, warmup=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)
    torch.testing.assert_close(sdpa().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    lib = event_ms(torch, sdpa, 20)
    backends = {}
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION):
        try:                             # a backend that refuses raises
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                with sdpa_kernel([b]):
                    backends[b.name] = round(event_ms(torch, sdpa, 10), 4)
        except RuntimeError as e:
            backends[b.name] = "refused: " + str(e).strip().splitlines()[0]
    pairs = PREFILL_B * H * (PREFILL_S * (PREFILL_S + 1) // 2)
    k4_flops = 2 * (Dqk + Dv) * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    bms, by = bound_ms(nbytes, k4_flops, BF16_OPS_PER_S)
    log(f"[mla] K4 bf16 q {tuple(q.shape)} k {tuple(k.shape)} v "
        f"{tuple(v.shape)} causal (group 1; v a slice of kv_b's rows): max "
        f"|d| {err:.3e} against the plain version with p in bf16; "
        f"{ms:.4f} ms/launch = {k4_flops / ms / 1e9:.1f} TFLOP/s; bound "
        f"{bms:.4f} ms ({by}) = {bms / ms:.1%}; plain {plain:.3f} ms; "
        f"scaled_dot_product_attention {lib:.4f} ms (each fused backend "
        f"alone: {json.dumps(backends)}); {MLA_LAYERS} launches = "
        f"{MLA_LAYERS * ms / (t_prefill * 1e3):.1%} of the prefill; f32 at "
        f"({CHECK_B}, {H}, {F32_S}) max |d| {err32:.3e} (2e-5)")
    row = dict(name="flash_attention_mla", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:70",
               launches=launches["flash_attention"], max_abs_err=err, ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
               head_dims=[Dqk, Dv], q_shape=list(q.shape),
               v_shape=list(v.shape), f32_max_abs_err=err32,
               sdpa_backends=backends)
    del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"[mla] phase {time.perf_counter() - t_phase:.1f} s")
    return row


def first_call(store):
    """A ``record`` for ``spy`` that keeps the first call's arguments."""
    def record(args, kw):
        if not store:
            store.append((args, kw))
    return record


def ssm_model(torch, ops, dev, cfg, want_params, rng, tag) -> tuple:
    """One model of ``[ssm]`` in bf16 from a seeded generator: its
    parameter count against ``param_count`` and ``want_params``;
    ``make_prefill_step`` on 4 × 2,048 tokens (K4 once a period of a
    hybrid, no kernel in an SSM model), tokens/s beside the FLOP ceiling,
    peak memory and, with an MoE, the drop share; ``ssd_chunked`` against
    the sequential ``ssd_reference`` on layer 0's real input (f32, 1e-4 of
    its largest magnitude); ``generate`` (no kernel) with ms/token-step
    beside the floor of the weights it reads and the f32 state it reads
    and writes, every logit finite.  Frees its weights; returns (the
    prefill's seconds, its launches)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, param_count, tree_leaves
    from repro_torch.models import mamba as SSM
    from repro_torch.models import moe as M
    from repro_torch.train import make_prefill_step

    s, mo = cfg.ssm, cfg.moe
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg) == want_params, f"{tag} parameter "
          f"count {n_params}, param_count {param_count(cfg)}, want "
          f"{want_params}")
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    di = s.expand * cfg.d_model
    log(f"[ssm] {tag}: {cfg.n_layers} layers, d_model {cfg.d_model}, SSD "
        f"d_inner {di} ({di // s.head_dim} heads of {s.head_dim}) d_state "
        f"{s.d_state} chunk {s.chunk}"
        + (f", attention {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd} at "
           f"sublayer {cfg.attn_index} of {cfg.attn_period}, d_ff "
           f"{cfg.d_ff}, {mo.n_experts} experts top-{mo.top_k} every "
           f"{mo.every}" if cfg.family == "hybrid" else "")
        + f", vocab {cfg.vocab}: {n_params} parameters = param_count "
        f"({weight_bytes / 1e9:.3f} GB = {weight_bytes / 2**30:.2f} GiB bf16)"
        f" built in {time.perf_counter() - t:.1f} s")

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    capacity = (M.expert_capacity(PREFILL_S, mo.top_k, mo.n_experts,
                                  mo.capacity_factor) if mo else 0)
    routing, ssd_in = [], []
    watch = [(SSM, "ssd_chunked", first_call(ssd_in))]
    if mo:
        watch.append((M, "moe_apply",
                       routing_recorder(torch, M, mo, capacity, routing)))
    k4 = cfg.n_layers // cfg.attn_period if cfg.family == "hybrid" else 0
    t_prefill, launches, peak = timed_prefill(
        torch, ops, make_prefill_step(cfg, dtype=torch.bfloat16), params,
        {"tokens": tokens}, spy(*watch), k4, cfg.padded_vocab, tag)
    flops = prefill_flops(cfg, PREFILL_B, PREFILL_S, capacity)
    ceiling = flops / BF16_OPS_PER_S
    log(f"[ssm] {tag} prefill B={PREFILL_B} S={PREFILL_S}: "
        f"{t_prefill * 1e3:.3f} ms = {PREFILL_B * PREFILL_S / t_prefill:.1f}"
        f" tokens/s (ceiling {flops:.4e} FLOP at 989 TFLOP/s = "
        f"{ceiling * 1e3:.3f} ms = {PREFILL_B * PREFILL_S / ceiling:.1f} "
        f"tokens/s; {flops / t_prefill / 1e12:.1f} TFLOP/s = "
        f"{ceiling / t_prefill:.1%} of the ceiling); peak device memory "
        f"{peak:.2f} GiB")
    if mo:
        check(len(routing) == cfg.n_layers // mo.every,
              f"{len(routing)} MoE sublayers ran")
        log(f"[ssm] {tag} routing: "
            + routing_summary(routing, capacity, PREFILL_S, 1))

    # the chunked scan against the sequential oracle on layer 0's input
    (x, dt, A, B, C, D), kw = ssd_in[0]
    got = SSM.ssd_chunked(x, dt, A, B, C, D, **kw)
    want = SSM.ssd_reference(x, dt, A, B, C, D)
    rel = float((got - want).abs().max() / want.abs().max())
    check(rel <= SSD_REL_TOL, f"{tag} ssd_chunked vs ssd_reference {rel}")
    log(f"[ssm] {tag} ssd_chunked (chunk {kw['chunk']}) vs the sequential "
        f"ssd_reference on layer 0's input x {tuple(x.shape)} f32: max |d| "
        f"{float((got - want).abs().max()):.3e} = {rel:.3e} of max |y| "
        f"{float(want.abs().max()):.3e} (tolerance {SSD_REL_TOL})")
    del ssd_in, x, dt, A, B, C, D, got, want, routing

    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    served, _ = timed_decode(torch, ops, generate, params, cfg, prompt,
                             MOE_TOKENS, tag)
    ms_step = served.seconds * 1e3 / served.steps
    # a step reads every weight but the embedding table (B rows) and reads
    # and writes every layer's f32 state; a hybrid's KV cache is a few MB
    state_bytes = 4 * SERVE_B * di * s.d_state * (cfg.n_layers - k4)
    step_bytes = (weight_bytes - params["embed"]["table"].numel() * 2
                  + 2 * state_bytes)
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[ssm] {tag} decode B={SERVE_B}, prompt {SERVE_PROMPT} + "
        f"{MOE_TOKENS} tokens from the SSM state: {served.steps} steps in "
        f"{served.seconds:.3f} s = {ms_step:.3f} ms/token-step (floor: "
        f"{step_bytes / 1e9:.3f} GB a step, the weights"
        + (", every expert at capacity 1," if mo else "")
        + f" and {2 * state_bytes / 1e6:.1f} MB of f32 state read and "
        f"written, at 3.35 TB/s = {floor_ms:.3f} ms, {floor_ms / ms_step:.1%}"
        f" of the step); logits finite; first tokens "
        f"{served.tokens[0][:16].tolist()}")
    del params, served
    gc.collect()
    torch.cuda.empty_cache()
    return t_prefill, launches


def ssm_f32_check(torch, ops, dev, cfg, rng, tag, hold) -> None:
    """``cfg`` in f32 at full width on 4 × 256 tokens.  Every mixer (each
    SSD sublayer; a hybrid period's attention, K4 f32 in the prefill) is
    fed its input in the prefill and run again in its decode form, one
    token a step from a zero state or cache: the two within 1e-4 of the
    prefill form's largest magnitude.  Then the last logits of ``prefill``
    against the decode loop's (the state filled one token a step): held
    within 2e-3 where ``hold``, else logged — a deep stack of random
    weights amplifies each layer's f32 rounding (mamba2-130m at full depth
    on the CPU, seed 2 of the reference's own weights: 2.4e-3 in the
    reference, 6.0e-3 in the port)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, lm, prefill
    from repro_torch.models import mamba as SSM

    p32 = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SSM_CHECK_B, SSM_CHECK_S))).to(dev)
    mixers = []
    ops.reset_launch_counts()
    with spy((SSM, "ssd_apply", lambda a, kw: mixers.append(("ssd", a, kw))),
             (lm, "_self_attention",
              lambda a, kw: mixers.append(("attn", a, kw)))):
        pre, _ = prefill(p32, {"tokens": prompt}, cfg, dtype=torch.float32)
    k4 = cfg.n_layers // cfg.attn_period if cfg.family == "hybrid" else 0
    check(ops.launch_counts().get("flash_attention", 0) == k4,
          f"the f32 {tag} prefill launched {ops.launch_counts()}")
    gaps = []
    for kind, args, kw in mixers:
        p, h = args[:2]
        B, S = h.shape[:2]
        if kind == "ssd":
            want = SSM.ssd_apply(p, h, **kw)
            state = torch.zeros(B, kw["d_inner"] // kw["head_dim"],
                                kw["d_state"], kw["head_dim"], device=dev)
            dims = {k: kw[k] for k in ("d_inner", "d_state", "head_dim")}
            got = [SSM.ssd_decode_step(p, h[:, t:t + 1], state, **dims)[0]
                   for t in range(S)]
        else:
            want = lm._self_attention(*args, **kw)
            ck, cv = (torch.zeros(B, S, cfg.n_kv_heads, cfg.hd, device=dev)
                      for _ in range(2))
            tp = lm.tensor_parallel(cfg)
            got = [lm._attn_decode(p, h[:, t:t + 1], ck, cv, cfg, tp, t)
                   for t in range(S)]
        gap = float((torch.cat(got, 1) - want).abs().max()
                    / want.abs().max())
        check(gap <= SSM_LAYER_TOL, f"f32 {tag} {kind} mixer: decode form "
              f"{gap} from the prefill form")
        gaps.append(gap)
    dec = generate(p32, cfg, prompt, 1, dtype=torch.float32)
    check(dec.finite, f"f32 {tag} decode logits not finite")
    gap = float((dec.prompt_logits - pre[:, -1]).abs().max())
    if hold:
        torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                                   atol=2e-3)
    log(f"[ssm] {tag} check: f32 at full width, {cfg.n_layers} layers, "
        f"B={SSM_CHECK_B}, prompt {SSM_CHECK_S}: each of the {len(gaps)} "
        f"mixers on its prefill input, prefill form (chunked SSD"
        + (", K4 f32" if k4 else "") + ") vs decode form stepped, at most "
        f"{max(gaps):.3e} of max |y| (tolerance {SSM_LAYER_TOL}); prefill "
        f"vs decode loop last logits max |d| {gap:.3e} "
        + ("(tolerance 2e-3)" if hold else "(logged: the stack amplifies "
           "rounding)"))
    del p32, pre, dec, mixers
    gc.collect()
    torch.cuda.empty_cache()


def ssm_phase(torch, ops, dev, k4_row) -> None:
    """``[ssm]``: mamba2-130m at full width and depth (24 SSD layers), then
    one 8-layer jamba period at published width with 8 of its 16 experts
    (``ssm_model`` each: count, prefill, scan check, decode), each model's
    f32 prefill-vs-decode check (jamba's period with 2 experts), and K4 at
    the jamba prefill's group-8 shape against its plain version (2e-2),
    timed beside its bound and SDPA; the jamba prefill's K4 launch joins
    K4's row."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config

    log(f"[ssm] before the phase: {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated ([mla]'s weights freed)")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(7)
    mamba = get_config(SSM_ARCH)
    ssm_model(torch, ops, dev, mamba, SSM_PARAMS, rng, "mamba2-130m")
    ssm_f32_check(torch, ops, dev, mamba, rng, "mamba2-130m", hold=False)
    ssm_f32_check(torch, ops, dev, dataclasses.replace(
        mamba, n_layers=CHECK_LAYERS), rng, "mamba2-130m", hold=True)

    full = get_config(HYB_ARCH)
    hyb = dataclasses.replace(full, n_layers=full.attn_period,
                              moe=dataclasses.replace(
                                  full.moe, n_experts=HYB_EXPERTS))
    log(f"[ssm] jamba: one period of {full.attn_period} of its "
        f"{full.n_layers} layers (reduced: n_layers, the smallest whole "
        f"period) and {HYB_EXPERTS} of its {full.moe.n_experts} experts "
        f"(reduced: n_experts, a width cut: 16 experts come to 90.29 GB in "
        f"bf16, above the card's 80 GB)")
    t_prefill, launches = ssm_model(torch, ops, dev, hyb, HYB_PARAMS, rng,
                                    "jamba")
    small = dataclasses.replace(hyb, moe=dataclasses.replace(
        hyb.moe, n_experts=HYB_CHECK_EXPERTS,
        capacity_factor=HYB_CHECK_EXPERTS / hyb.moe.top_k))
    ssm_f32_check(torch, ops, dev, small, rng,
                  f"jamba ({HYB_CHECK_EXPERTS} experts, capacity factor "
                  f"{HYB_CHECK_EXPERTS / hyb.moe.top_k}: no drop)", hold=True)

    # K4 at the jamba prefill's shape: 64 query heads over 8 KV heads
    Hq, Hkv, D = hyb.n_heads, hyb.n_kv_heads, hyb.hd
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(PREFILL_B, Hq, PREFILL_S, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(PREFILL_B, Hkv, PREFILL_S, D, generator=gen,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = float((got.float() - want.float()).abs().max())
    ms = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                  20)
    plain = event_ms(torch, lambda: ops.flash_attention_plain(
        q, k, v, causal=True), 3, warmup=1)
    lib = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    k4_flops = 4 * D * (PREFILL_S * (PREFILL_S + 1) // 2) * PREFILL_B * Hq
    bms, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), k4_flops,
                       BF16_OPS_PER_S)
    log(f"[ssm] K4 bf16 q {tuple(q.shape)} k/v {tuple(k.shape)} causal "
        f"(group {Hq // Hkv}): max |d| {err:.3e} against the plain version;"
        f" {ms:.4f} ms/launch = {k4_flops / ms / 1e9:.1f} TFLOP/s; bound "
        f"{bms:.4f} ms ({by}) = {bms / ms:.1%}; plain {plain:.3f} ms; "
        f"scaled_dot_product_attention {lib:.4f} ms; "
        f"{launches['flash_attention']} launch = "
        f"{launches['flash_attention'] * ms / (t_prefill * 1e3):.1%} of the "
        f"jamba prefill")
    k4_row["launches"] += launches["flash_attention"]
    del q, k, v, got, want
    torch.cuda.empty_cache()
    log(f"[ssm] phase {time.perf_counter() - t_phase:.1f} s")


def k4_yardstick(torch, ops, F, q, k, v, causal, reps=20):
    """K4 on (q, k, v) against its plain version (p in f32, 2e-2 in bf16;
    the max |d| to the plain version that rounds p as the kernel does is
    logged beside it), timed with CUDA events beside the plain version
    and ``scaled_dot_product_attention`` (a yardstick the port never
    calls).  Returns (err, err_rounded, ms, plain_ms, sdpa_ms, out)."""
    group = q.shape[1] // k.shape[1]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = float((got.float() - want.float()).abs().max())
    rounded = ops.flash_attention_plain(
        q, k, v, causal=causal, block_kv=ops.kernel_block_kv(v.shape[-1]),
        p_dtype=torch.bfloat16)
    err_rounded = float((got.float() - rounded.float()).abs().max())
    del want, rounded
    ms = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=causal),
                  reps)
    plain = event_ms(torch, lambda: ops.flash_attention_plain(
        q, k, v, causal=causal), 3, warmup=1)
    lib = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=group > 1), reps)
    return err, err_rounded, ms, plain, lib, got


def k4_f32_check(torch, ops, dev, H, Hkv, D, causal, seed):
    """K4's f32 path at (CHECK_B, H, F32_S, D) over Hkv KV heads against
    its plain version within 2e-5; returns the max |d|."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(CHECK_B, F32_S, H, D, generator=gen, device=dev)
    k, v = (torch.randn(CHECK_B, F32_S, Hkv, D, generator=gen, device=dev)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    return float((got - want).abs().max())


def serve_model(torch, dev, cfg, want_params, tag):
    """``cfg``'s weights in bf16 from a seeded generator, counted against
    ``param_count`` and ``want_params``.  Returns (params, their bytes, the
    bytes a decode step reads: every weight but the embedding table)."""
    from repro_torch.models import init_params, param_count, tree_leaves

    log(f"[{tag}] before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (the "
        f"earlier phases' weights freed)")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg) == want_params, f"{tag} parameter "
          f"count {n_params}, param_count {param_count(cfg)}, want "
          f"{want_params}")
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {n_params} parameters = param_count "
        f"({weight_bytes / 1e9:.3f} GB = {weight_bytes / 2**30:.2f} GiB bf16)"
        f" built in {time.perf_counter() - t:.1f} s")
    return (params, weight_bytes,
            weight_bytes - params["embed"]["table"].numel() * 2)


def log_prefill(tag, cfg, t_prefill, peak, flops, positions, what):
    ceiling = flops / BF16_OPS_PER_S
    log(f"[{tag}] prefill {what}: {t_prefill * 1e3:.3f} ms = "
        f"{positions / t_prefill:.1f} tokens/s (ceiling {flops:.4e} FLOP at "
        f"989 TFLOP/s = {ceiling * 1e3:.3f} ms = {positions / ceiling:.1f} "
        f"tokens/s; {flops / t_prefill / 1e12:.1f} TFLOP/s = "
        f"{ceiling / t_prefill:.1%} of the ceiling); peak device memory "
        f"{peak:.2f} GiB")


def encdec_phase(torch, ops, dev) -> dict:
    """``[encdec]``: seamless-m4t-large-v2 at full width and depth (24
    encoder + 24 decoder layers, d_model 1,024, 16 heads of 64, layernorm,
    ungated FFN 8,192, vocab 256,206; nothing cut), bf16, seeded.  The
    parameter count against ``param_count`` and the published 1,632,356,352;
    ``make_prefill_step`` on 4 × (1,024 seeded source frames as
    ``src_embeds`` + 1,024 tokens) with the counts zeroed before and read
    after: K4 exactly 72 times (24 non-causal encoder self-attentions, 24
    causal decoder self-attentions, 24 non-causal cross-attentions at Sq =
    Skv = 1,024), no other kernel; tokens/s beside the FLOP ceiling, peak
    memory.  ``generate`` (4 prompts of 16 tokens, 32 greedy tokens)
    against ``encode`` of the prefill's frames: K4 exactly 24 times a step
    (the cross-attention at Sq = 1, its k and v recomputed from the memory
    every step), ms/token-step beside its floor, every logit finite.  Then
    2 + 2 layers at full width in f32 on 77 frames for 100 tokens (Sm !=
    S): prefill's last logits against the decode loop's within 2e-3.
    Last, K4 at the prefill's shape (q, k, v (4, 16, 1024, 64) as
    transposed views, not causal) and at the decode's (Sq = 1) against
    its plain version (2e-2; f32 2e-5), timed beside its bound and SDPA.
    Returns K4's row at the prefill's shape, with the path's launches."""
    import dataclasses
    import math

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import encode, init_params, prefill
    from repro_torch.train import make_prefill_step

    cfg = get_config(ENCDEC_ARCH)
    t_phase = time.perf_counter()
    params, _, step_bytes = serve_model(torch, dev, cfg, ENCDEC_PARAMS,
                                        "encdec")
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    log(f"[encdec] {cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder "
        f"layers (nothing cut), d_model {d}, {H}/{Hkv} heads of {hd}, "
        f"{cfg.norm}, ungated d_ff {cfg.d_ff}, vocab {cfg.vocab}")
    rng = np.random.default_rng(9)
    gen = torch.Generator(device=dev).manual_seed(10)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, ENCDEC_S))).to(dev),
        "src_embeds": torch.randn(PREFILL_B, ENCDEC_SRC, d, generator=gen,
                                  device=dev, dtype=torch.bfloat16)}
    k4 = cfg.n_encoder_layers + 2 * cfg.n_layers
    t_prefill, launches, peak = timed_prefill(
        torch, ops, make_prefill_step(cfg, dtype=torch.bfloat16), params,
        batch, contextlib.nullcontext(), k4, cfg.padded_vocab, "encdec")
    flops = prefill_flops(cfg, PREFILL_B, ENCDEC_S, 0, Sm=ENCDEC_SRC)
    log_prefill("encdec", cfg, t_prefill, peak, flops,
                PREFILL_B * (ENCDEC_SRC + ENCDEC_S),
                f"B={PREFILL_B}, {ENCDEC_SRC} source frames + {ENCDEC_S} "
                f"tokens (tokens/s over both)")

    memory = encode(params, batch["src_embeds"], cfg, dtype=torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    served, dec_launches = timed_decode(
        torch, ops, generate, params, cfg, prompt, SERVE_TOKENS, "encdec",
        memory=memory, k4_step=cfg.n_layers)
    ms_step = served.seconds * 1e3 / served.steps
    # a step reads every weight but the embedding table and, in each
    # decoder layer, the memory (its k and v are recomputed from it)
    mem_bytes = cfg.n_layers * memory.numel() * 2
    kv_flops = cfg.n_layers * 2 * memory.shape[0] * memory.shape[1] * d \
        * 2 * Hkv * hd
    floor_ms, floor_by = bound_ms(step_bytes + mem_bytes, kv_flops,
                                  BF16_OPS_PER_S)
    log(f"[encdec] decode B={SERVE_B}, prompt {SERVE_PROMPT} + "
        f"{SERVE_TOKENS} tokens against the encoder's output of the "
        f"prefill's frames {tuple(memory.shape)}: {served.steps} steps in "
        f"{served.seconds:.3f} s = {ms_step:.3f} ms/token-step (floor: "
        f"{step_bytes / 1e9:.3f} GB of weights + {mem_bytes / 1e9:.3f} GB of "
        f"memory read a step at 3.35 TB/s, beside {kv_flops:.4e} FLOP of the "
        f"memory's k and v a step at 989 TFLOP/s = {floor_ms:.3f} ms "
        f"({floor_by}), {floor_ms / ms_step:.1%} of the step); K4 "
        f"{dec_launches.get('flash_attention', 0)} launches = "
        f"{cfg.n_layers} a step; logits finite; first tokens "
        f"{served.tokens[0][:16].tolist()}")
    del params, served, memory, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 check: 2 + 2 layers at full width, Sm != S
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS,
                                n_encoder_layers=CHECK_LAYERS)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (CHECK_B, CHECK_PROMPT))).to(dev)
    src = torch.randn(CHECK_B, CHECK_SRC, d, generator=gen, device=dev)
    ops.reset_launch_counts()
    pre, _ = prefill(p32, {"tokens": prompt, "src_embeds": src}, small,
                     dtype=torch.float32)
    check(ops.launch_counts().get("flash_attention") == 3 * CHECK_LAYERS,
          f"the f32 encdec prefill launched {ops.launch_counts()}")
    memory = encode(p32, src, small, dtype=torch.float32)
    dec = generate(p32, small, prompt, 1, dtype=torch.float32, memory=memory)
    check(dec.finite, "f32 encdec decode logits not finite")
    torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                               atol=2e-3)
    log(f"[encdec] check: {CHECK_LAYERS} + {CHECK_LAYERS} layers at full "
        f"width, f32, B={CHECK_B}, {CHECK_SRC} source frames, prompt "
        f"{CHECK_PROMPT}: prefill (K4 f32, non-causal encoder and "
        f"cross-attention) vs decode loop (cross-attention on K4 at Sq = 1) "
        f"last logits max |d| "
        f"{float((dec.prompt_logits - pre[:, -1]).abs().max()):.3e} "
        f"(tolerance 2e-3)")
    del p32, pre, dec, memory, src
    gc.collect()
    torch.cuda.empty_cache()

    # K4 at the prefill's shape (the encoder's self-attention; the
    # decoder's cross-attention runs the same one), as the model passes
    # it, and at the decode's cross-attention (one q row)
    def qkv(Sq, Skv):
        q = torch.randn(PREFILL_B, Sq, H, hd, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(PREFILL_B, Skv, Hkv, hd, generator=gen,
                            device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        return (t.transpose(1, 2) for t in (q, k, v))

    q, k, v = qkv(ENCDEC_SRC, ENCDEC_SRC)
    err, err_r, ms, plain, lib, got = k4_yardstick(torch, ops, F, q, k, v,
                                                   False)
    k4_flops = 4 * hd * ENCDEC_SRC * ENCDEC_SRC * PREFILL_B * H
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    bms, by = bound_ms(nbytes, k4_flops, BF16_OPS_PER_S)
    err32 = k4_f32_check(torch, ops, dev, H, Hkv, hd, False, 11)
    q1, k1, v1 = qkv(1, ENCDEC_SRC)
    err1, _, ms1, plain1, lib1, _ = k4_yardstick(torch, ops, F, q1, k1, v1,
                                                 False)
    bms1, by1 = bound_ms(2 * (2 * q1.numel() + k1.numel() + v1.numel()),
                         4 * hd * ENCDEC_SRC * PREFILL_B * H, BF16_OPS_PER_S)
    n_dec = dec_launches["flash_attention"]
    log(f"[encdec] K4 bf16 q/k/v {tuple(q.shape)} not causal (group "
        f"{H // Hkv}; transposed views): max |d| {err:.3e} against the plain "
        f"version ({err_r:.3e} against it with p rounded as the kernel "
        f"rounds it); {ms:.4f} ms/launch = {k4_flops / ms / 1e9:.1f} "
        f"TFLOP/s; bound {bms:.4f} ms ({by}) = {bms / ms:.1%}; plain "
        f"{plain:.3f} ms; scaled_dot_product_attention {lib:.4f} ms; "
        f"{2 * cfg.n_layers} of the prefill's {k4} launches at this shape = "
        f"{2 * cfg.n_layers * ms / (t_prefill * 1e3):.1%} of the prefill; "
        f"f32 at ({CHECK_B}, {H}, {F32_S}) max |d| {err32:.3e} (2e-5)")
    log(f"[encdec] K4 bf16 q {tuple(q1.shape)} over k/v {tuple(k1.shape)} "
        f"not causal (the decode's cross-attention; 1 of the q tile's 128 "
        f"rows live): max |d| {err1:.3e}; {ms1:.4f} ms/launch; bound "
        f"{bms1:.4f} ms ({by1}) = {bms1 / ms1:.1%}; plain {plain1:.3f} ms; "
        f"scaled_dot_product_attention {lib1:.4f} ms; {cfg.n_layers} "
        f"launches a step = {cfg.n_layers * ms1 / ms_step:.1%} of the step")
    row = dict(name="flash_attention_encdec", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:70",
               launches=launches["flash_attention"] + n_dec,
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
               bound_by=by, library_ms=lib, head_dims=[hd, hd],
               q_shape=list(q.shape), causal=False,
               prefill_launches=launches["flash_attention"],
               decode_launches=n_dec, f32_max_abs_err=err32,
               decode_q_shape=list(q1.shape), decode_ms=ms1,
               decode_max_abs_err=err1, decode_bound_ms=bms1,
               decode_library_ms=lib1)
    del q, k, v, got, q1, k1, v1
    torch.cuda.empty_cache()
    log(f"[encdec] phase {time.perf_counter() - t_phase:.1f} s")
    return row


def vlm_phase(torch, ops, dev) -> dict:
    """``[vlm]``: pixtral-12b at full width and depth (40 layers, d_model
    5,120, GQA 32/8 of head dim 160, rope θ 1e9, d_ff 14,336, vocab
    131,072; nothing cut), bf16, seeded.  The parameter count against
    ``param_count`` and the published 12,772,070,400; ``make_prefill_step``
    on 4 × (256 seeded ``prefix_embeds`` + 1,792 tokens) = 4 × 2,048
    positions with the counts zeroed before and read after: K4 exactly 40
    times (causal, group 4, D 160), no other kernel; tokens/s beside the
    FLOP ceiling, peak memory.  ``generate`` (4 prompts of 16 tokens, 32
    greedy tokens; a vlm's decode embeds tokens only; no kernel),
    ms/token-step beside the weight-read floor, every logit finite.  Then
    2 layers at full width in f32: prefill's last logits (K4 f32 at 160)
    against the decode loop's within 2e-3.  Last, K4 at (4, 32, 2048, 160)
    over k/v (4, 8, 2048, 160) as the model passes them against its plain
    version (2e-2; f32 2e-5), timed beside its bound and SDPA.  Returns
    K4's row at head dim 160."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params, prefill
    from repro_torch.train import make_prefill_step

    cfg = get_config(VLM_ARCH)
    t_phase = time.perf_counter()
    params, _, step_bytes = serve_model(torch, dev, cfg, VLM_PARAMS, "vlm")
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    P = cfg.prefix_tokens
    log(f"[vlm] {cfg.n_layers} layers (nothing cut), d_model {d}, {H}/{Hkv} "
        f"heads of {hd}, rope theta {cfg.rope_theta:g}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {P} prefix positions")
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=dev).manual_seed(13)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S - P))).to(dev),
        "prefix_embeds": torch.randn(PREFILL_B, P, d, generator=gen,
                                     device=dev, dtype=torch.bfloat16)}
    t_prefill, launches, peak = timed_prefill(
        torch, ops, make_prefill_step(cfg, dtype=torch.bfloat16), params,
        batch, contextlib.nullcontext(), cfg.n_layers, cfg.padded_vocab,
        "vlm")
    flops = prefill_flops(cfg, PREFILL_B, PREFILL_S, 0)
    log_prefill("vlm", cfg, t_prefill, peak, flops, PREFILL_B * PREFILL_S,
                f"B={PREFILL_B}, {P} prefix positions + {PREFILL_S - P} "
                f"tokens")
    del batch

    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    served, _ = timed_decode(torch, ops, generate, params, cfg, prompt,
                             SERVE_TOKENS, "vlm")
    ms_step = served.seconds * 1e3 / served.steps
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[vlm] decode B={SERVE_B}, prompt {SERVE_PROMPT} + {SERVE_TOKENS} "
        f"tokens (no prefix): {served.steps} steps in {served.seconds:.3f} s "
        f"= {ms_step:.3f} ms/token-step (floor: {step_bytes / 1e9:.3f} GB of "
        f"weights per step at 3.35 TB/s = {floor_ms:.3f} ms, "
        f"{floor_ms / ms_step:.1%} of the step); logits finite; first tokens "
        f"{served.tokens[0][:16].tolist()}")
    del params, served
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 check: 2 layers at full width (a vlm's decode embeds tokens
    # only, so its prefill runs without the prefix)
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (CHECK_B, CHECK_PROMPT))).to(dev)
    ops.reset_launch_counts()
    pre, _ = prefill(p32, {"tokens": prompt}, small, dtype=torch.float32)
    check(ops.launch_counts().get("flash_attention") == CHECK_LAYERS,
          "the f32 vlm prefill did not run on K4")
    dec = generate(p32, small, prompt, 1, dtype=torch.float32)
    check(dec.finite, "f32 vlm decode logits not finite")
    torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                               atol=2e-3)
    log(f"[vlm] check: {CHECK_LAYERS} layers at full width, f32, "
        f"B={CHECK_B}, prompt {CHECK_PROMPT}: prefill (K4 f32 at head dim "
        f"{hd}) vs decode loop last logits max |d| "
        f"{float((dec.prompt_logits - pre[:, -1]).abs().max()):.3e} "
        f"(tolerance 2e-3)")
    del p32, pre, dec
    gc.collect()
    torch.cuda.empty_cache()

    # K4 at the prefill's shape, as the model passes it
    q = torch.randn(PREFILL_B, PREFILL_S, H, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn(PREFILL_B, PREFILL_S, Hkv, hd, generator=gen,
                        device=dev, dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    err, err_r, ms, plain, lib, got = k4_yardstick(torch, ops, F, q, k, v,
                                                   True)
    pairs = PREFILL_B * H * (PREFILL_S * (PREFILL_S + 1) // 2)
    k4_flops = 4 * hd * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    bms, by = bound_ms(nbytes, k4_flops, BF16_OPS_PER_S)
    err32 = k4_f32_check(torch, ops, dev, H, Hkv, hd, True, 14)
    log(f"[vlm] K4 bf16 q {tuple(q.shape)} k/v {tuple(k.shape)} causal "
        f"(group {H // Hkv}, head dim {hd}; transposed views): max |d| "
        f"{err:.3e} against the plain version ({err_r:.3e} against it with "
        f"p rounded as the kernel rounds it); {ms:.4f} ms/launch = "
        f"{k4_flops / ms / 1e9:.1f} TFLOP/s; bound {bms:.4f} ms ({by}) = "
        f"{bms / ms:.1%}; plain {plain:.3f} ms; scaled_dot_product_attention "
        f"{lib:.4f} ms; {cfg.n_layers} launches = "
        f"{cfg.n_layers * ms / (t_prefill * 1e3):.1%} of the prefill; f32 at "
        f"({CHECK_B}, {H}, {F32_S}) max |d| {err32:.3e} (2e-5)")
    row = dict(name="flash_attention_d160", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:70",
               launches=launches["flash_attention"], max_abs_err=err, ms=ms,
               plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
               head_dims=[hd, hd], q_shape=list(q.shape),
               kv_shape=list(k.shape), causal=True,
               rounded_max_abs_err=err_r, f32_max_abs_err=err32)
    del q, k, v, got
    torch.cuda.empty_cache()
    log(f"[vlm] phase {time.perf_counter() - t_phase:.1f} s")
    return row


def named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def leaf_at(tree, keys):
    """The leaf of ``tree`` at ``keys`` (dict keys and list indices)."""
    for k in keys:
        tree = tree[k]
    return tree


def k4_train_shape_f32(torch, ops, q, k, v, do) -> dict:
    """K4's f32 path at a training shape, causal, on the values of the
    bf16 check: the forward's log-sum-exp against the plain version's
    (1e-4 absolute), and dq, dk, dv through ``FlashAttention`` (the f32
    kernel, then ``flash_attention_backward``) against autograd of the
    plain version, each within 1e-4 of the plain gradient's largest
    magnitude.  Returns the LSE's max |d| and each gradient's max |d| over
    its largest magnitude."""
    from repro_torch.kernels import flash_attention as K4

    q, k, v, do = (t.float() for t in (q, k, v, do))
    _, lse = K4._kernel(q, k, v, True, None, with_lse=True)
    _, want = ops.flash_attention_plain(q, k, v, causal=True,
                                        return_lse=True)
    out = {"lse": float((lse - want).abs().max())}
    check(out["lse"] <= 1e-4, f"K4 f32 lse at {tuple(q.shape)}: max |d| "
          f"{out['lse']:.3e} above 1e-4")
    del lse, want
    grads = []
    for fn in (ops.flash_attention, ops.flash_attention_plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, causal=True), leaves,
                                         do))
        del leaves
        torch.cuda.empty_cache()
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        scale = float(want.abs().max())
        out[name] = float((got - want).abs().max()) / scale
        check(out[name] <= 1e-4, f"K4 f32 {name} at {tuple(q.shape)}: max "
              f"|d| {out[name]:.3e} of its largest magnitude {scale:.3e}, "
              f"above 1e-4")
    del grads, q, k, v, do
    torch.cuda.empty_cache()
    return out


def k4_train_check(torch, ops, dev, B, H, Hkv, S, D, seed, Dv=None,
                   nope=0, causal=True, twin_excuses=False):
    """K4 at a training shape, bf16, causal unless ``causal`` is False, as
    the model passes it
    (transposed views of seeded (B, S, H, D); with ``nope``, MLA's: v a
    slice of ``kv_b``'s rows past the ``nope`` columns, k the materialised
    ``kf`` whose last D − nope columns broadcast one shared rope head;
    v's head dim ``Dv``, D's by default): the forward against the
    plain version's output (2e-2, K4's bf16 tolerance) and log-sum-exp
    (1e-3 absolute: f32 arithmetic on both sides); the backward kernel
    (``flash_attention_backward``, one launch) from them against its
    rounding twin (``flash_attention_backward_plain`` with
    ``round_dtype=torch.bfloat16`` on f32 copies of the same inputs): dq,
    dk, dv within 5e-3 of each one's largest magnitude (the two sum in
    another order, and the kernel rounds its results to bf16, at most
    2⁻⁹ of a value), and against autograd of the plain version (2e-2,
    K4's bf16 tolerance; with ``twin_excuses``, an element may lie outside
    it only where the rounding twin's does too: the tolerance is fixed and
    absolute, and at large GQA groups the bf16 rounding of P and dS alone
    can put an element of dk or dv past it).  Returns (q, k, v, do), K4's
    (o, lse), each max |d| by name (``twin``: each gradient's max |d| over
    its largest magnitude, and the max |d| of all three; ``excused_d*``:
    the elements outside 2e-2) and the plain version's
    forward + backward as a function."""
    from repro_torch.kernels import flash_attention as K4

    gen = torch.Generator(device=dev).manual_seed(seed)
    Dv = Dv or D

    def act(h, d=D, s=S):
        return torch.randn(B, s, h, d, generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
    if nope:
        kv = act(Hkv, nope + Dv).transpose(1, 2)
        k = torch.cat([kv[..., :nope], act(1, D - nope).transpose(
            1, 2).expand(B, S, Hkv, D - nope)], -1).transpose(1, 2)
        v = kv[..., nope:].transpose(1, 2)
        q, do = act(H), act(H, Dv)
    else:
        q, k, v, do = act(H), act(Hkv), act(Hkv, Dv), act(H, Dv)
    o, lse = K4._kernel(q, k, v, causal, None, with_lse=True)
    want_o, want_lse = ops.flash_attention_plain(q, k, v, causal=causal,
                                                 return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    err = {"o": float((o.float() - want_o.float()).abs().max()),
           "lse": float((lse - want_lse).abs().max())}
    del want_o, want_lse
    ops.reset_launch_counts()
    got = ops.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    check(ops.launch_counts() == {"flash_attention_bwd": 1}, f"K4's "
          f"backward at {tuple(q.shape)} launched {ops.launch_counts()}")
    f32 = [t.float() for t in (q, k, v, o, lse, do)]
    twin = {"max_abs": 0.0}
    twins = ops.flash_attention_backward_plain(*f32, causal,
                                               round_dtype=torch.bfloat16)
    for name, g, w in zip("qkv", got, twins):
        scale = float(w.abs().max())
        d = float((g.float() - w).abs().max())
        check(d <= 5e-3 * scale, f"K4's backward kernel d{name} at "
              f"{tuple(q.shape)}: max |d| {d:.3e} from its rounding twin, "
              f"above 5e-3 × {scale:.3e}")
        twin[f"d{name}"] = d / scale
        twin["max_abs"] = max(twin["max_abs"], d)
    err["twin"] = twin
    del f32
    if not twin_excuses:
        twins = (None,) * 3
    torch.cuda.empty_cache()

    def plain_grads():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(ops.flash_attention_plain(
            *leaves, causal=causal), leaves, do)
    for name, g, w, t in zip("qkv", got, plain_grads(), twins):
        if t is None:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)
        else:
            w = w.float()
            tol = 2e-2 + 2e-2 * w.abs()
            out = (g.float() - w).abs() > tol
            twin_out = (t - w).abs() > tol
            bad = int((out & ~twin_out).sum())
            check(not bad, f"K4's backward kernel d{name} at "
                  f"{tuple(q.shape)}: {bad} elements outside 2e-2 of "
                  f"plain autograd where its rounding twin is within it")
            err[f"excused_d{name}"] = int(out.sum())
        err[f"d{name}"] = float((g.float() - w.float()).abs().max())
    del got, twins
    torch.cuda.empty_cache()
    return (q, k, v, do), (o, lse), err, plain_grads


def k4_bwd_yardsticks(torch, ops, F, q, k, v, o, lse, do, causal=True):
    """Beside K4's backward kernel: the tensor code that was its backward
    (``flash_attention_backward_plain``, CUDA events) and
    ``scaled_dot_product_attention``'s backward alone (``autograd.grad``
    through a kept forward, profiler device time) and forward + backward
    (CUDA events), yardsticks the port never calls."""
    H, Hkv = q.shape[1], k.shape[1]
    tensor_code = event_ms(torch, lambda: ops.flash_attention_backward_plain(
        q, k, v, o, lse, do, causal), 2, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=H != Hkv)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10)
    del out, leaves

    def sdpa_grads():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=H != Hkv)
        return torch.autograd.grad(out, leaves, do)
    lib = event_ms(torch, sdpa_grads, 10)
    torch.cuda.empty_cache()
    return tensor_code, lib_bwd, lib


def k4_bounds(q, k, v, o, lse, do, pairs):
    """K4's bounds at bf16 (an unmasked pair: forward 2·(D + Dv), backward
    2·(3·D + 2·Dv), forward + backward 6·(D + Dv) — 4·D, 10·D and 12·D
    where D = Dv — at the bf16 peak; each input read once, each output
    written once): ((ms, by) of each)."""
    D, Dv = q.shape[-1], v.shape[-1]
    qkvo = 2 * (q.numel() + k.numel() + v.numel() + o.numel())
    grads = 2 * (q.numel() + k.numel() + v.numel())
    return (bound_ms(qkvo + 4 * lse.numel(), 2 * (D + Dv) * pairs,
                     BF16_OPS_PER_S),
            bound_ms(qkvo + 2 * do.numel() + 4 * lse.numel() + grads,
                     2 * (3 * D + 2 * Dv) * pairs, BF16_OPS_PER_S),
            bound_ms(qkvo + 2 * do.numel() + grads, 6 * (D + Dv) * pairs,
                     BF16_OPS_PER_S))


def k4_bwd_log(tag, rec):
    """One line of K4's backward at a training shape."""
    log(f"{tag} K4 backward kernel q {tuple(rec['q_shape'])} k/v "
        f"{tuple(rec['kv_shape'])} causal, bf16, profiler device time: "
        f"{rec['bwd_ms']:.4f} ms (bound {rec['bwd_bound_ms']:.4f}, "
        f"{rec['bwd_bound_by']}, {rec['bwd_bound_ms'] / rec['bwd_ms']:.1%});"
        f" dq/dk/dv within {rec['twin']['dq']:.3e}/{rec['twin']['dk']:.3e}/"
        f"{rec['twin']['dv']:.3e} of their largest magnitudes of the "
        f"rounding twin (5e-3), max |d| {rec['dq']:.3e}/{rec['dk']:.3e}/"
        f"{rec['dv']:.3e} against autograd of the plain version (2e-2); "
        f"the tensor code {rec['tensor_code_bwd_ms']:.3f} ms "
        f"({rec['tensor_code_bwd_ms'] / rec['bwd_ms']:.1f}× the kernel); "
        f"plain forward + backward {rec['plain_fwd_bwd_ms']:.3f} ms; "
        f"scaled_dot_product_attention backward "
        f"{rec['sdpa_bwd_ms']:.4f} ms; K4 forward + backward "
        f"{rec['fwd_bwd_ms']:.4f} ms (bound {rec['fwd_bwd_bound_ms']:.4f}, "
        f"{rec['fwd_bwd_bound_ms'] / rec['fwd_bwd_ms']:.1%}) against "
        f"scaled_dot_product_attention forward + backward "
        f"{rec['sdpa_fwd_bwd_ms']:.4f} ms "
        f"({rec['fwd_bwd_ms'] / rec['sdpa_fwd_bwd_ms']:.2f}×)")


def k4_train_shape(torch, ops, F, dev, B, H, Hkv, S, D, seed, reps=10):
    """K4 at a training shape (``k4_train_check``), then the same in f32 on
    the same values (``k4_train_shape_f32``: every late row and KV block
    held, not only the large entries of the first rows).  Timed beside
    their bounds (``k4_bounds``): the forward with CUDA events, the
    backward kernel by the profiler's device time, the plain version's
    forward + backward, and ``k4_bwd_yardsticks``."""
    from repro_torch.kernels import flash_attention as K4

    (q, k, v, do), (o, lse), err, plain_grads = k4_train_check(
        torch, ops, dev, B, H, Hkv, S, D, seed)
    o_err, lse_err, twin = err.pop("o"), err.pop("lse"), err.pop("twin")
    grad_err = err
    f32_err = k4_train_shape_f32(torch, ops, q, k, v, do)

    fwd = event_ms(torch, lambda: K4._kernel(q, k, v, True, None,
                                             with_lse=True), reps)
    bwd = device_ms(torch, lambda: ops.flash_attention_backward(
        q, k, v, o, lse, do, True), reps)
    plain = event_ms(torch, plain_grads, 2, warmup=1)
    lib_fwd = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=H != Hkv), reps)
    tensor_code, lib_bwd, lib = k4_bwd_yardsticks(torch, ops, F, q, k, v, o,
                                                  lse, do)
    fwd_b, bwd_b, both_b = k4_bounds(q, k, v, o, lse, do,
                                     B * H * (S * (S + 1) // 2))
    rec = dict(q_shape=list(q.shape), kv_shape=list(k.shape), causal=True,
               fwd_ms=fwd, fwd_bound_ms=fwd_b[0], fwd_bound_by=fwd_b[1],
               bwd_ms=bwd, bwd_bound_ms=bwd_b[0], bwd_bound_by=bwd_b[1],
               fwd_bwd_ms=fwd + bwd, tensor_code_bwd_ms=tensor_code,
               plain_fwd_bwd_ms=plain, sdpa_fwd_ms=lib_fwd,
               sdpa_bwd_ms=lib_bwd, sdpa_fwd_bwd_ms=lib,
               fwd_bwd_bound_ms=both_b[0], o_max_abs_err=o_err,
               lse_max_abs_err=lse_err, **grad_err, twin=twin,
               f32_rel_err=f32_err, bwd_timed_by=timed_by(bwd))
    log(f"[train] K4 q {tuple(q.shape)} k/v {tuple(k.shape)} causal, bf16: "
        f"forward with LSE {fwd:.4f} ms (bound {fwd_b[0]:.4f}, {fwd_b[1]}, "
        f"{fwd_b[0] / fwd:.1%}; o max |d| {o_err:.3e}, lse {lse_err:.3e}); "
        f"in f32 lse max |d| {f32_err['lse']:.3e} (1e-4), dq/dk/dv within "
        + "/".join(f"{f32_err[n]:.3e}" for n in ("dq", "dk", "dv"))
        + " of their largest magnitudes (1e-4; the f32 backward is the "
        f"tensor code); scaled_dot_product_attention forward {lib_fwd:.4f} "
        f"ms")
    k4_bwd_log("[train]", rec)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return rec


def train_phase(torch, ops, dev) -> dict:
    """``[train]``, with the serving phases' weights freed: stablelm-1.6b
    (24 layers, d_model 2,048, 32 heads of 64, layernorm, ungated FFN
    5,632, vocab 100,352; nothing cut) trained on one card: f32 masters
    and bf16 compute through ``make_train_step(..., dtype=bf16)``, AdamW
    under the launcher's cosine schedule (lr 3e-3, warmup steps // 10), 10
    steps of ``batch_at`` (8 × 2,048 tokens, seed 0).  The parameter count
    against ``param_count`` and 1,367,543,808; per step the loss and
    ms/step (synchronized), with the counts zeroed before and read after:
    K4 exactly 48 times (24 forward, 24 remat recompute) and its backward
    kernel 24 times, no other kernel;
    over steps 2–9 tokens/s, peak memory and the share of the ceiling
    (``train_flops`` at 989 TFLOP/s).  Checks: every loss finite, the last
    below the first; at step 0 every gradient leaf finite and non-zero.
    Then 2 layers at full width in f32: every gradient leaf through K4's
    f32 kernel and its backward against the same step with the plain
    version under autograd (1e-4 of each leaf's largest magnitude), and
    that step's AdamW update on the card against the same on the CPU
    (1e-5).  K4's forward and backward at (8, 32, 2048, 64) and qwen2-7b's
    (4, 28, 2048, 128) over (4, 4, 2048, 128) (``k4_train_shape``), and
    the backward kernel's share of a step (24 launches at the first
    shape's device time over ms/step).
    Last, checkpoint-restart at the reduced config through ``ft.run``: a
    run killed at step 5 by ``fail_at_step`` and resumed from its step-4
    checkpoint gives the uninterrupted run's losses within rtol 1e-4 (the
    embedding's gradient sums with float atomics).  Returns K4's and its
    backward kernel's launches in the 10 steps and the training-shape
    records."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.dist import ft
    from repro_torch.models import init_params, param_count, tree_leaves
    from repro_torch.profile import (TRAIN_ARCH, TRAIN_B, TRAIN_LR, TRAIN_S,
                                     TRAIN_STEPS)
    from repro_torch.train import (Optimizer, adamw, cosine_schedule,
                                   make_train_step)

    cfg = get_config(TRAIN_ARCH)
    t_phase = time.perf_counter()
    log(f"[train] before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg) == TRAIN_PARAMS, f"train parameter "
          f"count {n_params}, param_count {param_count(cfg)}, want "
          f"{TRAIN_PARAMS}")
    log(f"[train] {cfg.name}: {cfg.n_layers} layers (nothing cut), d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters = "
        f"param_count ({4 * n_params / 1e9:.3f} GB f32 masters) built in "
        f"{time.perf_counter() - t:.1f} s")

    base = adamw(schedule=cosine_schedule(TRAIN_LR, warmup=TRAIN_STEPS // 10,
                                          total=TRAIN_STEPS))
    step0 = []

    def update(grads, state, p, step):
        if step == 0:                   # one host read for every leaf
            names, leaves = zip(*named_leaves(grads))
            flags = torch.stack([torch.stack([torch.isfinite(g).all(),
                                              (g != 0).any()])
                                 for g in leaves]).cpu()
            step0.extend(zip(names, flags.tolist()))
        return base.update(grads, state, p, step)
    opt = Optimizer("adamw", base.init, update)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, dtype=torch.bfloat16)
    dcfg = DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    want_k4 = {"flash_attention": 2 * cfg.n_layers,
               "flash_attention_bwd": cfg.n_layers}
    losses, ms, k4_launches, bwd_launches = [], [], 0, 0
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_at(dcfg, i).items()}
        if i == TRAIN_TIMED_FROM:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        launches = ops.launch_counts()
        losses.append(loss.item())
        log(f"[train] step {i}: loss {losses[-1]:.4f}, {ms[-1]:.1f} ms, "
            f"launches {json.dumps(launches)}")
        check(launches == want_k4, f"train step {i} launched {launches}, "
              f"not K4 twice a layer and its backward once {want_k4}")
        k4_launches += launches["flash_attention"]
        bwd_launches += launches["flash_attention_bwd"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    bad = [name for name, (finite, nonzero) in step0
           if not (finite and nonzero)]
    check(len(step0) == len(tree_leaves(params)) and not bad,
          f"step 0: gradient leaves not finite or all zero: {bad}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train losses {losses}: not finite, or the last not below the "
          f"first")
    lo, hi = TRAIN_TIMED_FROM, TRAIN_STEPS
    t_step = sum(ms[lo:hi]) / (hi - lo) / 1e3
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    ceiling = flops / BF16_OPS_PER_S
    log(f"[train] {TRAIN_STEPS} AdamW steps of {TRAIN_B} × {TRAIN_S} tokens "
        f"(bf16 compute, f32 masters): loss {losses[0]:.4f} → "
        f"{losses[-1]:.4f}; steps {lo}–{hi - 1}: {t_step * 1e3:.3f} ms/step "
        f"= {tokens / t_step:.1f} tokens/s (ceiling {flops:.4e} FLOP at 989 "
        f"TFLOP/s = {ceiling * 1e3:.3f} ms = {tokens / ceiling:.1f} "
        f"tokens/s; {flops / t_step / 1e12:.1f} TFLOP/s = "
        f"{ceiling / t_step:.1%} of the ceiling); peak device memory "
        f"{peak:.2f} GiB; every one of the {len(step0)} gradient leaves "
        f"finite and non-zero at step 0; K4 {want_k4['flash_attention']} "
        f"launches a step, its backward kernel "
        f"{want_k4['flash_attention_bwd']}")
    del params, opt_state, step_fn, loss, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the gradient against the plain path: 2 layers at full width, f32
    small = dataclasses.replace(cfg, n_layers=2)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(
        DataConfig(cfg.vocab, GRAD_CHECK_S, GRAD_CHECK_B, seed=1), 0).items()}
    base32, seen = adamw(lr=1e-3), []

    def record(grads, state, p, step):
        seen.append(grads)
        return base32.update(grads, state, p, step)
    spy32 = Optimizer("adamw", base32.init, record)
    state0 = spy32.init(p32)
    ops.reset_launch_counts()
    card_p, card_s, _ = make_train_step(small, spy32, dtype=torch.float32)(
        p32, state0, batch, 0)
    check(ops.launch_counts() == {"flash_attention": 2 * small.n_layers},
          f"the f32 check's step launched {ops.launch_counts()}")
    with plain_attention(ops):
        ops.reset_launch_counts()
        make_train_step(small, spy32, dtype=torch.float32)(p32, state0,
                                                           batch, 0)
        check(not ops.launch_counts(), "the plain step launched a kernel")
    worst = 0.0
    for (name, got), want in zip(named_leaves(seen[0]), tree_leaves(seen[1])):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-4 * scale, f"gradient {name}: max |d| {err:.3e} "
              f"between K4 and the plain version, above 1e-4 × {scale:.3e}")
        worst = max(worst, err / scale)
    del seen[1]
    torch.cuda.empty_cache()

    def host(tree):
        return [x.cpu() for x in tree_leaves(tree)]
    from repro_torch.train.optimizer import tree_unflatten
    cpu_g, cpu_s0, cpu_p = (tree_unflatten(tr, host(tr))
                            for tr in (seen[0], state0, p32))
    t = time.perf_counter()
    want_p, want_s = base32.update(cpu_g, cpu_s0, cpu_p, 0)
    t_host = time.perf_counter() - t
    opt_err = 0.0
    for got, want in zip(host([card_p, card_s]),
                         tree_leaves([want_p, want_s])):
        tol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        opt_err = max(opt_err, float((got - want).abs().max()))
    log(f"[train] check: {small.n_layers} layers at full width, f32, "
        f"{GRAD_CHECK_B} × {GRAD_CHECK_S} tokens: every gradient leaf "
        f"through K4 (f32 kernel, its backward) within "
        f"{worst:.3e} of its largest magnitude of autograd through the "
        f"plain version (1e-4); the AdamW step on the card against the CPU's "
        f"(host {t_host:.1f} s): max |d| {opt_err:.3e} (1e-5 relative)")
    del p32, card_p, card_s, seen, state0, batch, cpu_g, cpu_s0, cpu_p
    del want_p, want_s
    gc.collect()
    torch.cuda.empty_cache()

    # K4 forward and backward at the training shapes
    records = [k4_train_shape(torch, ops, F, dev, TRAIN_B, cfg.n_heads,
                              cfg.n_kv_heads, TRAIN_S, cfg.hd, 21),
               k4_train_shape(torch, ops, F, dev, PREFILL_B, 28, 4,
                              PREFILL_S, 128, 22)]
    bwd_step = want_k4["flash_attention_bwd"] * records[0]["bwd_ms"]
    log(f"[train] {t_step * 1e3:.3f} ms/step; the backward kernel "
        f"{want_k4['flash_attention_bwd']} launches × "
        f"{records[0]['bwd_ms']:.4f} ms = {bwd_step:.3f} ms = "
        f"{bwd_step / (t_step * 1e3):.1%} of a step; K4's forward "
        f"{want_k4['flash_attention']} × {records[0]['fwd_ms']:.4f} ms = "
        f"{want_k4['flash_attention'] * records[0]['fwd_ms'] / (t_step * 1e3):.1%}")

    # checkpoint-restart at the reduced config
    red = cfg.reduced()

    def ft_run(ckpt_dir, **kw):
        o = adamw(schedule=cosine_schedule(TRAIN_LR, FT_STEPS // 10,
                                           FT_STEPS))
        fn = make_train_step(red, o, dtype=torch.float32,
                             loss_chunk=max(32, FT_S // 4))
        p = init_params(red, torch.Generator(device=dev).manual_seed(3))
        d = DataConfig(red.vocab, FT_S, FT_B, seed=3)

        def data_fn(i):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in batch_at(d, i).items()}
        return ft.run(fn, p, o.init(p), data_fn, FT_STEPS,
                      ft.FTConfig(ckpt_dir=ckpt_dir, ckpt_every=2, **kw),
                      log_every=0)

    with tempfile.TemporaryDirectory() as tmp:
        _, _, full, _ = ft_run(f"{tmp}/a")
        failed = None
        try:
            ft_run(f"{tmp}/b", fail_at_step=FT_FAIL)
        except RuntimeError as e:
            failed = str(e)
        check(failed == f"injected failure at step {FT_FAIL}",
              f"the killed run did not fail at step {FT_FAIL}: {failed}")
        _, _, tail, state = ft_run(f"{tmp}/b")
    check(state.restarts == 1 and len(tail) == FT_STEPS - FT_FAIL,
          f"the resumed run: restarts {state.restarts}, {len(tail)} steps")
    np.testing.assert_allclose(tail, full[FT_FAIL:], rtol=1e-4)
    log(f"[train] checkpoint-restart at the reduced config ({red.n_layers} "
        f"layers, d_model {red.d_model}, f32, {FT_B} × {FT_S} tokens, "
        f"checkpoints every 2 steps): killed at step {FT_FAIL}, resumed from "
        f"step {FT_FAIL - 1}: losses {[round(x, 6) for x in tail]} against "
        f"the uninterrupted run's {[round(x, 6) for x in full[FT_FAIL:]]} "
        f"(rtol 1e-4; max rel "
        f"{max(abs(a / b - 1) for a, b in zip(tail, full[FT_FAIL:])):.2e})")
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": k4_launches, "bwd_launches": bwd_launches,
            "shapes": records, "losses": losses, "ms": ms, "peak_gib": peak,
            "bwd_step_share": bwd_step / (t_step * 1e3)}


# ---------------------------------------------------------- [train-families]
# every other LM family trained on one card after [train] (its weights
# freed): each model at published width, bf16 compute with f32 masters
# through make_train_step, the optimizer launch.dryrun.optimizer_default
# picks for its full config (Adafactor from 3e10 parameters at mp 16)
# under the launcher's cosine schedule (warmup steps // 10, so none) from
# TF_LR, TF_STEPS steps
# of PREFILL_B × PREFILL_S positions (seamless ENCDEC_SRC seeded frames +
# ENCDEC_S tokens a row, pixtral its 256 seeded prefix embeddings + 1,792
# tokens).  Cut so that the f32 masters, their gradients and the
# optimizer's state (≈ 16 B a parameter with AdamW, 8 with Adafactor, + 2
# for the bf16 copy) fit the card: pixtral 4 of its 40 layers; llama4-scout
# 1 of 48 layers with all 16 experts; deepseek-v3 1 dense + 1 MoE layer
# with 32 of its 256 experts (top-8, the shared expert kept); jamba's
# period cut to 2 sublayers (SSD with the dense FFN, attention with the
# MoE, 4 of 16 experts), as [family-mesh]'s f32 check; mamba2-130m and
# seamless-m4t-large-v2 whole.  The f32 witness at one layer (deepseek:
# an MoE layer; seamless: 1 + 1; jamba: the period) on GRAD_CHECK_B ×
# GRAD_CHECK_S positions
TF_STEPS = 3
TF_TIMED_FROM = 1                   # steps from it make ms/step
# the first updates of a random init move every weight by about ± lr
# (AdamW's first is exactly that), so a layer's output by about lr times
# its fan-in: at published width [train]'s 3e-3 sent 4 of the 6 losses up
# after the first step and 3e-4 sent 5; at TF_LR each falls at every step
TF_LR = 1e-5
TF_VLM_LAYERS, TF_MLA_EXPERTS, TF_HYB_EXPERTS = 4, 32, 4
TF_PARAMS = {"mamba2": 167_616_960, "seamless": 1_632_356_352,
             "pixtral": 2_485_171_200, "llama4": 4_273_044_480,
             "deepseek": 4_077_521_920, "jamba": 4_651_574_016}
# each model's peak device memory at PREFILL_B rows stays below this
# (every cut above is sized for it)
TF_PEAK_GIB = 70
# K4's forward row of each model's head dims in the kernels line
TF_K4_ROW = {"seamless": "flash_attention_encdec",
             "pixtral": "flash_attention_d160", "llama4": "flash_attention",
             "deepseek": "flash_attention_mla", "jamba": "flash_attention"}


def train_family_models(get_config) -> list:
    """(tag, full config, the trained cut, the f32 witness's config) of
    each model ``[train-families]`` trains, in its order."""
    import dataclasses as dc
    mb, sm, px, l4, ds, jb = (get_config(a) for a in (
        "mamba2_130m", "seamless_m4t_large_v2", "pixtral_12b",
        "llama4_scout_17b_a16e", "deepseek_v3_671b", "jamba_1_5_large_398b"))
    ds_moe = dc.replace(ds.moe, first_k_dense=1, n_experts=TF_MLA_EXPERTS)
    jb_cut = dc.replace(jb, n_layers=2, attn_period=2, attn_index=1,
                        moe=dc.replace(jb.moe, n_experts=TF_HYB_EXPERTS))
    return [
        ("mamba2", mb, mb, dc.replace(mb, n_layers=1)),
        ("seamless", sm, sm, dc.replace(sm, n_layers=1, n_encoder_layers=1)),
        ("pixtral", px, dc.replace(px, n_layers=TF_VLM_LAYERS),
         dc.replace(px, n_layers=1)),
        ("llama4", l4, dc.replace(l4, n_layers=1), dc.replace(l4, n_layers=1)),
        ("deepseek", ds, dc.replace(ds, n_layers=2, moe=ds_moe),
         dc.replace(ds, n_layers=1, moe=dc.replace(ds_moe, first_k_dense=0))),
        ("jamba", jb, jb_cut, jb_cut),
    ]


def family_train_batch(torch, cfg, rows, S, Sm, step, gen, dev) -> dict:
    """One step's batch of ``cfg`` on the card, S positions a row:
    ``batch_at``'s tokens and labels (seed 0, step ``step``); an
    encoder–decoder's over Sm seeded source frames; a vlm's
    ``prefix_tokens`` seeded prefix embeddings ahead of S − P tokens, their
    labels −1."""
    from repro_torch.data import DataConfig, batch_at
    extra, P = {}, 0
    if cfg.family == "encdec":
        extra["src_embeds"] = torch.randn(rows, Sm, cfg.d_model,
                                          generator=gen, device=dev)
    elif cfg.prefix_tokens:
        P = cfg.prefix_tokens
        extra["prefix_embeds"] = torch.randn(rows, P, cfg.d_model,
                                             generator=gen, device=dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(
        DataConfig(cfg.vocab, S - P, rows, seed=0), step).items()}
    if P:
        b["labels"] = torch.cat([torch.full((rows, P), -1, device=dev,
                                            dtype=b["labels"].dtype),
                                 b["labels"]], 1)
    return {**b, **extra}


@contextlib.contextmanager
def plain_attention(ops):
    """The models' attention on K4's plain version (GQA in ``models.lm``,
    MLA in ``models.attention``) while the block runs."""
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    reals = lm.flash_attention, A.flash_attention
    lm.flash_attention = A.flash_attention = ops.flash_attention_plain
    try:
        yield
    finally:
        lm.flash_attention, A.flash_attention = reals


def family_witness(torch, ops, dev, tag, cfg) -> float:
    """The f32 witness of ``[train-families]``: ``cfg`` (one layer at
    full width) on GRAD_CHECK_B × GRAD_CHECK_S positions, every gradient
    leaf of ``make_grad_fn`` through K4's f32 kernel (and its backward, the
    f32 tensor code) against the same with the plain version under
    autograd, within 1e-4 of the leaf's largest magnitude.  Returns the
    worst leaf's share."""
    from repro_torch.models import init_params
    from repro_torch.train import make_grad_fn

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = family_train_batch(torch, cfg, GRAD_CHECK_B, GRAD_CHECK_S,
                               GRAD_CHECK_S, 0, gen, dev)
    grad_fn = make_grad_fn(cfg, dtype=torch.float32)
    calls = len(attention_calls(cfg))
    ops.reset_launch_counts()
    _, got = grad_fn(params, batch)
    check(ops.launch_counts() == ({"flash_attention": 2 * calls} if calls
                                  else {}),
          f"[train-families] {tag} f32 witness launched "
          f"{ops.launch_counts()}, not K4 {2 * calls} times")
    with plain_attention(ops):
        ops.reset_launch_counts()
        _, want = grad_fn(params, batch)
        check(not ops.launch_counts(), f"[train-families] {tag}: the plain "
              f"witness launched {ops.launch_counts()}")
    worst = 0.0
    for (name, _), g, w in zip(named_leaves(params), got, want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        check(err <= 1e-4 * scale, f"[train-families] {tag} f32 gradient "
              f"{name}: max |d| {err:.3e} between K4 and the plain version, "
              f"above 1e-4 × {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    del params, got, want, batch
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def train_family(torch, ops, dev, tag, full, cfg, witness) -> dict:
    """One model of ``[train-families]`` (see ``train_families_phase``).
    Returns its launches, step times, losses, peak and the f32 witness's
    worst share."""
    import numpy as np
    from repro_torch.kernels import flash_attention as K4
    from repro_torch.launch.dryrun import optimizer_default
    from repro_torch.models import init_params, param_count, tree_leaves
    from repro_torch.models import moe as M
    from repro_torch.models.moe import expert_capacity
    from repro_torch.train import (Optimizer, cosine_schedule,
                                   get_optimizer, make_train_step)

    t_model = time.perf_counter()
    rows = PREFILL_B
    S, Sm = (ENCDEC_S, ENCDEC_SRC) if cfg.family == "encdec" else (
        PREFILL_S, 0)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg) == TF_PARAMS[tag], f"[train-families]"
          f" {tag} parameter count {n_params}, param_count "
          f"{param_count(cfg)}, want {TF_PARAMS[tag]}")
    name = optimizer_default(full)
    base = get_optimizer(name, schedule=cosine_schedule(
        TF_LR, warmup=TF_STEPS // 10, total=TF_STEPS))
    step0 = {}

    def update(grads, state, p, step):
        if step == 0:                   # one host read for every leaf
            names, leaves = zip(*named_leaves(grads))
            flags = torch.stack([torch.stack([torch.isfinite(g).all(),
                                              (g != 0).any()])
                                 for g in leaves])
            experts = [(n, (g != 0).flatten(1).any(1))
                       for n, g in zip(names, leaves) if "/experts/" in n]
            flat = torch.cat([flags.flatten()] + [e for _, e in experts])
            flat = flat.cpu().tolist()
            step0["leaves"] = list(zip(names, zip(flat[0::2][:len(names)],
                                                  flat[1::2][:len(names)])))
            at = 2 * len(names)
            step0["experts"] = []
            for n, e in experts:
                step0["experts"].append((n, flat[at:at + e.numel()]))
                at += e.numel()
            step0["load"] = layer_loads(p)
        return base.update(grads, state, p, step)

    def layer_loads(p):
        """Each MoE layer's expert load of step 0 by its path: the first
        recorded call (the forward's; the checkpoint runs it again in the
        backward) whose router is the layer's master cast as the step
        casts it."""
        masters = dict(named_leaves(p))
        loads = {}
        for n in masters:
            if n.endswith("/router/w"):
                w = masters[n]
                hits = [load for r, (*_, load) in zip(routers, routing)
                        if r.equal(w.to(r.dtype))]
                check(hits, f"[train-families] {tag}: no recorded MoE call "
                      f"routes with {n}")
                loads[n[:-len("/router/w")]] = hits[0]
        return loads
    opt = Optimizer(name, base.init, update)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(3)
    calls = len(attention_calls(cfg))
    want = ({"flash_attention": 2 * calls, "flash_attention_bwd": calls}
            if calls else {})
    mo = cfg.moe
    capacity = (expert_capacity(S, mo.top_k, mo.n_experts,
                                mo.capacity_factor) if mo else 0)
    routing, routers = [], []
    record_routing = routing_recorder(torch, M, mo, capacity, routing)

    def record_layer(args, kw):         # and the router it routed with
        record_routing(args, kw)
        routers.append(args[0]["router"]["w"])
    bwd_events, at_step = [], [0]
    real_bwd = K4._backward_kernel

    def timed_bwd(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_bwd(*args)
        ev[1].record()
        bwd_events.append((at_step[0], *ev))
        return out
    losses, ms, launches = [], [], {}
    K4._backward_kernel = timed_bwd
    try:
        for i in range(TF_STEPS):
            at_step[0] = i
            batch = family_train_batch(torch, cfg, rows, S, Sm, i, gen, dev)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            watch = (spy((M, "moe_apply", record_layer)) if i == 0 and mo
                     else contextlib.nullcontext())
            t = time.perf_counter()
            with watch:
                params, opt_state, loss = step_fn(params, opt_state, batch, i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(loss.item())
            got = ops.launch_counts()
            check(got == want, f"[train-families] {tag} step {i} launched "
                  f"{got}, not K4 twice an attention call and its backward "
                  f"once {want}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
    finally:
        K4._backward_kernel = real_bwd
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"[train-families] {tag} losses "
          f"{losses} not finite")
    check(peak <= TF_PEAK_GIB, f"[train-families] {tag} peak device "
          f"memory {peak:.2f} GiB above {TF_PEAK_GIB} GiB at {rows} rows")
    bad = [n for n, (finite, nonzero) in step0["leaves"]
           if not finite or (not nonzero and "/experts/" not in n)]
    check(len(step0["leaves"]) == len(tree_leaves(params)) and not bad,
          f"[train-families] {tag} step 0: gradient leaves not finite or "
          f"all zero: {bad}")
    # an expert's slices are zero exactly where its layer's routing gave
    # it no token
    idle = 0
    for n, nonzero in step0["experts"]:
        load = step0["load"][n.rsplit("/experts/", 1)[0]]
        zero = [e for e, nz in enumerate(nonzero) if not nz]
        empty = [e for e in range(len(nonzero)) if int(load[e]) == 0]
        check(zero == empty, f"[train-families] {tag} step 0 {n}: zero "
              f"gradient at experts {zero}, no token routed to {empty}")
        idle += len(zero)
    t_step = sum(ms[TF_TIMED_FROM:]) / (TF_STEPS - TF_TIMED_FROM) / 1e3
    bwd_ms = sum(s.elapsed_time(e) for i, s, e in bwd_events
                 if i >= TF_TIMED_FROM) / (TF_STEPS - TF_TIMED_FROM)
    tokens = rows * (S + Sm)
    flops = train_flops(cfg, rows, S, capacity, Sm)
    ceiling = flops / BF16_OPS_PER_S
    falls = losses[-1] < losses[0]
    del params, opt_state, step_fn, loss, batch
    gc.collect()
    torch.cuda.empty_cache()
    worst = family_witness(torch, ops, dev, tag, witness)
    log(f"[train-families] {tag} ({cfg.name}: {n_params} parameters = "
        f"param_count; {name}, lr {TF_LR:g}): {rows} × {S} positions"
        + (f" over {Sm} source frames" if Sm else "")
        + f", {TF_STEPS} steps; losses {[round(x, 4) for x in losses]} "
        f"({'fall' if falls else 'do not fall'}; not gated); steps "
        f"{TF_TIMED_FROM}–{TF_STEPS - 1}: {t_step * 1e3:.1f} ms/step = "
        f"{tokens / t_step:.1f} tokens/s (ceiling {flops:.4e} FLOP at 989 "
        f"TFLOP/s = {ceiling * 1e3:.3f} ms, {ceiling / t_step:.1%} of it); "
        f"peak device memory {peak:.2f} GiB (within {TF_PEAK_GIB} GiB); "
        f"step 0: {len(step0['leaves'])} gradient leaves finite and "
        f"non-zero, {idle} expert slices with no token routed exactly zero; "
        f"launches a step {json.dumps(want)}; the backward kernel "
        f"{bwd_ms:.3f} ms a step (CUDA events around its launches) = "
        f"{bwd_ms / (t_step * 1e3):.1%} of the step; f32 witness at "
        f"{witness.n_layers} layer(s): every gradient leaf through K4 "
        f"within {worst:.3e} of its largest magnitude of the plain "
        f"version's (1e-4); {time.perf_counter() - t_model:.1f} s")
    return {"tag": tag, "launches": launches, "losses": losses,
            "ms": ms, "ms_step": t_step * 1e3, "peak_gib": peak,
            "bwd_ms_step": bwd_ms, "ceiling_ms": ceiling * 1e3,
            "witness": worst, "params": n_params, "optimizer": name,
            "rows": rows}


def sdpa_backward(torch, F, q, k, v, do, causal=True, reps=10):
    """``scaled_dot_product_attention``'s backward as the dispatcher runs
    it on these inputs, a yardstick the port never calls: (the fused
    backend it takes, its backward's profiler device time), or ("none
    accepts", None) where only the math backend would take them."""
    from torch.nn.attention import SDPBackend
    gqa = q.shape[1] != k.shape[1]
    name = SDPBackend(torch._fused_sdp_choice(
        q, k, v, None, 0.0, causal, scale=None, enable_gqa=gqa)).name
    if name in ("MATH", "ERROR"):
        return "none accepts", None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=gqa)
        ms = device_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), reps)
    except RuntimeError as e:
        return f"{name} refused: {str(e).strip().splitlines()[0]}", None
    finally:
        del leaves
        torch.cuda.empty_cache()
    return name, ms


def k4_bwd_shape(torch, ops, F, dev, tag, B, H, Hkv, S, D, Dv, nope, seed,
                 causal=True, twin_excuses=False, reps=10) -> dict:
    """K4's backward kernel at a training shape of ``[train-families]``
    (``k4_train_check``: against its rounding twin within 5e-3 and plain
    autograd within 2e-2), timed by the profiler's device time beside its
    bound, the tensor code (CUDA events) and ``sdpa_backward``."""
    (q, k, v, do), (o, lse), err, plain_grads = k4_train_check(
        torch, ops, dev, B, H, Hkv, S, D, seed, Dv=Dv, nope=nope,
        causal=causal, twin_excuses=twin_excuses)
    excused = {n: err[n] for n in ("excused_dq", "excused_dk", "excused_dv")
               if n in err}
    if twin_excuses:    # the library's bf16 backward under the same gate
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_grads = torch.autograd.grad(F.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=H != Hkv), leaves, do)
        excused["sdpa_outside"] = [
            int(((g.float() - w.float()).abs()
                 > 2e-2 + 2e-2 * w.float().abs()).sum())
            for g, w in zip(lib_grads, plain_grads())]
        del leaves, lib_grads
    bwd = device_ms(torch, lambda: ops.flash_attention_backward(
        q, k, v, o, lse, do, causal), reps)
    tensor_code = event_ms(torch, lambda: ops.flash_attention_backward_plain(
        q, k, v, o, lse, do, causal), 2, warmup=1)
    backend, lib = sdpa_backward(torch, F, q, k, v, do, causal, reps)
    _, (bms, by), _ = k4_bounds(q, k, v, o, lse, do, B * H * (
        S * (S + 1) // 2 if causal else S * S))
    rec = dict(q_shape=list(q.shape), kv_shape=list(k.shape),
               v_shape=list(v.shape), causal=causal, bwd_ms=bwd,
               bwd_bound_ms=bms, bwd_bound_by=by,
               tensor_code_bwd_ms=tensor_code, sdpa_bwd_ms=lib,
               sdpa_backend=backend, twin=err["twin"],
               **{n: err[n] for n in ("dq", "dk", "dv")}, **excused,
               bwd_timed_by=timed_by(bwd))
    log(f"[train-families] K4 backward kernel at {tag}'s q "
        f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
        f"{'causal' if causal else 'not causal'}, bf16"
        + ("; v a slice of kv_b's rows, k the materialised kf" if nope
           else "") + f": {bwd:.4f} ms, profiler device "
        f"time (bound {bms:.4f}, {by}, {bms / bwd:.1%}); dq/dk/dv within "
        f"{err['twin']['dq']:.3e}/{err['twin']['dk']:.3e}/"
        f"{err['twin']['dv']:.3e} of their largest magnitudes of the "
        f"rounding twin (5e-3), max |d| {err['dq']:.3e}/{err['dk']:.3e}/"
        f"{err['dv']:.3e} against autograd of the plain version (2e-2"
        + (f"; outside it, where the rounding twin is too: dq/dk/dv "
           f"{excused['excused_dq']}/{excused['excused_dk']}/"
           f"{excused['excused_dv']} elements; scaled_dot_product_"
           f"attention's backward has "
           f"{'/'.join(map(str, excused['sdpa_outside']))} outside it"
           if excused else "")
        + "); the "
        f"tensor code {tensor_code:.3f} ms ({tensor_code / bwd:.1f}× the "
        f"kernel); scaled_dot_product_attention backward: {backend}"
        + (f", {lib:.4f} ms ({bwd / lib:.2f}×)" if lib else ""))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return rec


def train_families_phase(torch, ops, dev, rows) -> None:
    """``[train-families]``, after ``[train]`` with its weights freed:
    mamba2-130m, seamless-m4t-large-v2, pixtral-12b (4 of 40 layers),
    llama4-scout (1 of 48 layers, 16 experts), deepseek-v3 (1 dense + 1
    MoE layer, 32 of 256 experts) and jamba-1.5-large (a period of 2
    sublayers, 4 of 16 experts), each trained at published width on this
    card: f32 masters, bf16 compute (``make_train_step``), the optimizer
    ``optimizer_default`` picks for the full config, TF_STEPS steps of
    4 × 2,048 positions (``train_family``).  Checks: the parameter count
    against ``param_count``; every loss finite (whether it falls is
    logged); at step 0 every gradient leaf finite and non-zero but the
    experts the routing gave no token, whose slices are exactly zero;
    each step K4 exactly twice an attention call (the forward and the
    remat recompute) and its backward kernel once, no other kernel
    (mamba2 none); the f32 witness at one layer (``family_witness``).
    Logged: ms/step, tokens/s beside ``train_flops``' ceiling, peak
    memory, the backward kernel's share of a step.  Then K4's backward
    at pixtral's (4, 32/8, 2048, 160), deepseek MLA's (4, 128/128, 2048,
    192/128), seamless's non-causal (4, 16/16, 1024, 64), llama4's (4,
    40/8, 2048, 128) and jamba's (4, 64/8, 2048, 128) (``k4_bwd_shape``;
    jamba's with the twin's excuses).  The kernels line's K4 rows gain
    the steps' forward launches by head dims, and ``flash_attention_bwd``
    its launches and the five shapes."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train-families] before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    runs = [train_family(torch, ops, dev, tag, full, cfg, witness)
            for tag, full, cfg, witness in train_family_models(get_config)]
    models = {r["tag"]: c for r, (_, _, c, _) in zip(
        runs, train_family_models(get_config))}
    sm, px, l4, ds, jb = (models[t] for t in (
        "seamless", "pixtral", "llama4", "deepseek", "jamba"))
    m = ds.mla
    shapes = [k4_bwd_shape(torch, ops, F, dev, "pixtral", PREFILL_B,
                           px.n_heads, px.n_kv_heads, PREFILL_S, px.hd,
                           px.hd, 0, 51),
              k4_bwd_shape(torch, ops, F, dev, "deepseek", PREFILL_B,
                           ds.n_heads, ds.n_heads, PREFILL_S,
                           m.nope_dim + m.rope_dim, m.v_dim, m.nope_dim, 52),
              # the encoder's self-attention and the cross-attention (its
              # ENCDEC_S queries over as many source frames)
              k4_bwd_shape(torch, ops, F, dev, "seamless", PREFILL_B,
                           sm.n_heads, sm.n_kv_heads, ENCDEC_S, sm.hd,
                           sm.hd, 0, 53, causal=False),
              k4_bwd_shape(torch, ops, F, dev, "llama4", PREFILL_B,
                           l4.n_heads, l4.n_kv_heads, PREFILL_S, l4.hd,
                           l4.hd, 0, 54),
              k4_bwd_shape(torch, ops, F, dev, "jamba", PREFILL_B,
                           jb.n_heads, jb.n_kv_heads, PREFILL_S, jb.hd,
                           jb.hd, 0, 55, twin_excuses=True)]
    row = {r["name"]: r for r in rows}
    bwd = sum(r["launches"].get("flash_attention_bwd", 0) for r in runs)
    for r in runs:
        if r["tag"] in TF_K4_ROW:
            row[TF_K4_ROW[r["tag"]]]["launches"] += r["launches"][
                "flash_attention"]
    row["flash_attention_bwd"]["launches"] += bwd
    row["flash_attention_bwd"]["family_shapes"] = shapes
    row["flash_attention_bwd"]["family_launches"] = {
        r["tag"]: r["launches"].get("flash_attention_bwd", 0) for r in runs}
    log(f"[train-families] K4 backward kernel launches in the phase {bwd} "
        f"(row flash_attention_bwd), K4's by model "
        + json.dumps({r["tag"]: r["launches"].get("flash_attention", 0)
                      for r in runs})
        + f"; phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- [dist]
# the paper's parallel mechanism as ranks on one card: the sharded
# partitioner (stream slices), then the GAS engine one partition a rank

DIST_NODES = 4                   # stream slices of the sharded partitioner
DIST_GAS_K = 8                   # partitions = ranks of the per-rank engine
DIST_ITERS = 30
DIST_WIRES = ("dense", "halo", "quantized", "ragged", "ragged_quantized")
DIST_LOSSY = ("quantized", "ragged_quantized")
DIST_LOSSY_BOUND = 5e-4          # [exchange]'s bound on a lossy pagerank
DRYRUN_ITERS = 1                 # iterations of a [dryrun] cell


def dist_gas_job(mesh, sess):
    """``[dist]``'s per-rank runs in one spawn of k ranks (SPMD on the
    bound mesh, on the session's layout; rank 0 returns the values, every
    rank's report and the dry-run's records)."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.graph import engine as eng
    from repro_torch.launch.dryrun import graph_cells
    lay = sess.partition_layout
    V = lay.num_vertices
    pr = eng.pagerank_program(V)
    out = {"started": float(coll.pmax(torch.tensor(
        [time.time()], dtype=torch.float64), mesh))}
    for ex in DIST_WIRES:
        for name in ("pagerank", "cc"):
            out[ex, name] = eng.shard_map_gas(
                eng.get_program(name, V), lay, mesh, DIST_ITERS, exchange=ex,
                return_wire=True)
    out["bundle"] = eng.shard_map_gas_many(
        [eng.get_program(p, V) for p in GAS_F32_BUNDLE], lay, mesh,
        DIST_ITERS, exchange="halo", return_wire=True)
    out["tol"] = eng.shard_map_gas(pr, lay, mesh, GAS_CAP, exchange="halo",
                                   tol=PR_TOL, return_iters=True,
                                   return_wire=True)
    out["overlap"] = eng.shard_map_gas(pr, lay, mesh, DIST_ITERS,
                                       exchange="ragged", overlap=True,
                                       return_wire=True)
    t = time.perf_counter()
    out["dryrun"] = graph_cells(mesh, sess, SCALE, DRYRUN_ITERS)
    out["dryrun_s"] = time.perf_counter() - t
    return out


def dist_partition_job(mesh, runs):
    """``[dist]``'s card partitions, SPMD on one spawn of the stream
    mesh's ranks: ``partition(..., backend="sharded")`` of each (graph,
    config), timed on the ranks.  Rank 0 returns the results, the wall
    seconds of each and ``started``, the wall-clock time at which the last
    rank began its job."""
    import torch
    from repro_torch.core.partitioner import partition
    from repro_torch.dist import collectives as coll
    started = coll.pmax(torch.tensor([time.time()], dtype=torch.float64),
                        mesh)
    out = []
    for gr, cfg in runs:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = partition(gr.src, gr.dst, gr.num_vertices, cfg,
                        backend="sharded", nodes=mesh.size, mesh=mesh)
        out.append((res, time.perf_counter() - t))
    return {"results": out, "started": float(started)}


def dist_check_partition_launches(res, game: bool, tag):
    """Every rank of a sharded partition on the card: K1 once a
    clustering pass, T twice (the first walk and the restream), the CSR
    K2 when the game is on, no other kernel."""
    for n in res.stats["per_node"]:
        got = {k: v for k, v in n["launches"].items() if v}
        want = {"cluster_scatter": 1 + n["cap_retries"],
                "transform_scan": 2}
        if game:
            check(got.get("game_bestresponse_csr", 0) > 0,
                  f"{tag}: rank {n['node']} never launched the CSR K2")
            want["game_bestresponse_csr"] = got["game_bestresponse_csr"]
        check(got == want, f"{tag}: rank {n['node']} launched {got}, "
              f"not {want}")


def dist_check_k3(reports, per_iter, iters, tag):
    """Every rank of a per-rank GAS run: K3 ``per_iter`` times an
    iteration, no other kernel."""
    for r, w in enumerate(reports):
        got = {k: v for k, v in w["launches"].items() if v}
        want = {"ell_spmv": per_iter * iters} if per_iter else {}
        check(got == want, f"[dist] {tag}: rank {r} launched {got}, not "
              f"{want}")


def dryrun_phase(sess, recs, seconds) -> int:
    """``[dryrun]``: the graph dry-run's records from ``[dist]``'s spawn
    (every byte cell one iteration on the k = 8 ranks), held to the byte
    model and the reference's gate, then the session's stacked early exit
    on this card.  Returns the K3 launches of the phase (the ranks' cells
    and the early exit)."""
    from repro_torch.graph.engine import PROGRAM_NAMES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as dr
    lay = sess.partition_layout
    k = lay.k
    t = time.perf_counter()
    check(len(recs) == len(PROGRAM_NAMES) * len(dr.GRAPH_EXCHANGES)
          + 1 + len(dr.OVERLAP_CELLS), f"[dryrun] {len(recs)} records")
    for r in recs:
        model = r["comm_bytes_model"]
        want = model * (k - 1) // k if r["exchange"] == "dense" else model
        tag = (f"[dryrun] {r['program']} on {r['exchange']}"
               + (" overlapped" if r["overlap"] else ""))
        check(r["collective_bytes_wire"] == want, f"{tag}: counted "
              f"{r['collective_bytes_wire']} bytes an iteration, model "
              f"{model}")
        # K3 gathers each f32 program once an iteration on every rank
        f32 = [p for p in r.get("fused_programs", [r["program"]])
               if p in GAS_F32_BUNDLE]
        dist_check_k3([{"launches": w} for w in r["launches"]], len(f32),
                      DRYRUN_ITERS, tag)
    ops.reset_launch_counts()
    early = dr.early_exit_cell(sess, SCALE, DRYRUN_ITERS)
    launches = {n: c for n, c in ops.launch_counts().items() if c}
    # K3 once an iteration of the tol run and of the fixed rerun
    check(launches == {"ell_spmv": 2 * early["iters_run"]},
          f"[dryrun] the early exit launched {launches}")
    msgs = dr.check_graph_ordering(recs + [early])
    check(not msgs, "[dryrun] the gate: " + "; ".join(msgs))
    for line in dr.ratio_lines(recs):
        log(f"[dryrun] {line}")
    by = {(r["program"], r["exchange"]): r for r in recs
          if not r["fused"] and not r["overlap"]}
    for r in recs:
        if r["overlap"]:
            ref = by[r["program"], r["exchange"]]
            log(f"[dryrun] {r['program']} on {r['exchange']} overlapped: "
                f"{r['collective_bytes_wire']} bytes and "
                f"{r['collective_permute_count']} ring hops an iteration "
                f"(phase-ordered {ref['collective_bytes_wire']}, "
                f"{ref['collective_permute_count']})")
    held = (f"within rtol {early['early_exit_rtol']:g}: "
            f"{early['early_exit_close']}" if "early_exit_rtol" in early
            else "the gate holds it bit for bit")
    log(f"[dryrun] early exit: pagerank on ragged, tol {dr.EARLY_EXIT_TOL:g}, "
        f"stopped at {early['iters_run']} of {dr.EARLY_EXIT_CAP} on the "
        f"stacked engine; against the fixed run at {early['iters_run']} "
        f"iterations {held} (bit for bit: {early['early_exit_bitmatch']}); "
        f"{early['compile_s']:.2f} s")
    scalars = sum(r["collective_bytes_scalars"] for r in recs)
    k3 = sum(w.get("ell_spmv", 0) for r in recs for w in r["launches"])
    log(f"[dryrun] {len(recs)} cells on {k} ranks in {seconds:.1f} s, every "
        f"one at its byte model (dense at (k-1)/k), no gate message; the "
        f"global scalars (gas.aux) {scalars} bytes over the cells beside "
        f"the model; K3 {k3} launches on the ranks, "
        f"{launches['ell_spmv']} in the early exit; checks "
        f"{time.perf_counter() - t:.1f} s")
    return k3 + launches["ell_spmv"]


def dist_phase(g, main_res, main_seconds, pr_ref):
    """``[dist]``: the sharded partitioner at scale 16 and 20 and the
    per-rank GAS engine at scale 20 on every wire, ranks on this card
    over gloo; then the sharded partitioner on one NCCL rank."""
    import dataclasses

    import numpy as np
    from repro_torch.core import CLUGPConfig, metrics, web_graph
    from repro_torch.core.partitioner import partition
    from repro_torch.graph import engine as eng
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.launch.mesh import make_graph_mesh, make_stream_mesh
    from repro_torch.session import GraphSession, SessionConfig

    t_phase = time.perf_counter()
    note = ("ranks share this one card over gloo (staged through host "
            "memory): these times measure that transport, not a network")
    cfg = CLUGPConfig.optimized(K, restream=1)

    def sharded(gr, c, device=None, nodes=DIST_NODES, mesh=None):
        t = time.perf_counter()
        res = partition(gr.src, gr.dst, gr.num_vertices, c,
                        backend="sharded", nodes=nodes, device=device,
                        mesh=mesh)
        return res, time.perf_counter() - t

    # the CPU ranks' scale-16 partition (the card's witness) and the np
    # host combine run while the card's ranks work: one spawn of 4 card
    # ranks runs every card partition of the phase SPMD
    g16 = web_graph(scale=SMALL_SCALE, edge_factor=EDGE_FACTOR, seed=0)
    off = dataclasses.replace(cfg, game=False)

    def host_combine():
        t = time.perf_counter()
        res = partition(g16.src, g16.dst, g16.num_vertices, off,
                        backend="np", nodes=DIST_NODES)
        return res, time.perf_counter() - t

    pool = concurrent.futures.ThreadPoolExecutor(2)
    cpu_run = pool.submit(sharded, g16, cfg, "cpu")
    host_run = pool.submit(host_combine)
    t, wall = time.perf_counter(), time.time()
    runs = run_on_ranks(dist_partition_job, make_stream_mesh(DIST_NODES),
                        [(g16, off), (g16, cfg), (g, cfg)], timeout=900)
    s_spawn = time.perf_counter() - t
    (host, s_host), (cpu, s_cpu) = host_run.result(), cpu_run.result()
    (card, s_card), (on, s_on), (res, s20) = runs["results"]
    m = card.stats["mesh"]
    check(m["transport"] == "gloo" and m["device"] == "cuda",
          f"[dist] the ranks ran as {m}")
    check(np.array_equal(card.assign, host.assign),
          "[dist] game off: the sharded partition differs from the np host "
          "combine")
    dist_check_partition_launches(card, False, "[dist] scale 16 game off")
    log(f"[dist] {DIST_NODES} ranks on {m['device']} over {m['transport']} "
        f"in one spawn: {s_spawn:.1f} s, of which "
        f"{runs['started'] - wall:.1f} s until every rank ran (spawn, "
        f"imports, CUDA contexts)")
    log(f"[dist] scale {SMALL_SCALE} game off: equal to the np host combine "
        f"over {DIST_NODES} nodes edge for edge (rf {card.stats['rf']:.4f}; "
        f"{s_card:.2f} s on the card, {s_host:.2f} s host combine beside "
        f"the ranks)")
    diff = int((on.assign != cpu.assign).sum())
    check(diff == 0 and on.stats["game_rounds"] == cpu.stats["game_rounds"],
          f"[dist] game on: the card's sharded partition differs from the "
          f"CPU ranks' in {diff} edges")
    dist_check_partition_launches(on, True, "[dist] scale 16 game on")
    log(f"[dist] scale {SMALL_SCALE} game on: the card's partition equals 4 "
        f"CPU ranks' edge for edge (rf {on.stats['rf']:.4f}, "
        f"{on.stats['game_rounds']} rounds; {s_on:.2f} s card, {s_cpu:.2f} s "
        f"CPU with its spawn); launches per rank "
        f"{[n['launches'] for n in on.stats['per_node']]}")

    # scale 20: the graph path's stream on 4 ranks
    E, V = g.num_edges, g.num_vertices
    st = res.stats
    dist_check_partition_launches(res, True, "[dist] scale 20")
    rng = np.random.default_rng(0)
    rf_random = metrics.replication_factor(
        g.src, g.dst, rng.integers(0, K, E).astype(np.int32), V, K)
    check(res.assign.shape == (E,) and res.assign.min() >= 0
          and res.assign.max() < K, "[dist] scale 20: an edge unassigned")
    check(st["balance"] <= cfg.tau + 0.05,
          f"[dist] scale 20: balance {st['balance']:.4f} > tau + 0.05")
    check(st["rf"] < rf_random, "[dist] scale 20: RF not below random's")
    for n in st["per_node"]:
        game_calls = sum(v["calls"] for key, v in n["collectives"].items()
                         if key.startswith("game."))
        log(f"[dist] scale {SCALE} rank {n['node']}: {n['edges']} edges, "
            f"{n['clusters']} clusters, game {n['game_form']} "
            f"{n['game_rounds']} rounds, stage seconds "
            + json.dumps({k: round(v, 4)
                          for k, v in n["stage_seconds"].items()})
            + f", count-table all-reduce {n['prior_allreduce_seconds']:.4f} "
            f"s ({n['collectives']['restream.counts']['bytes'] / 2**20:.1f} "
            f"MiB), game collectives {game_calls}")
    log(f"[dist] scale {SCALE}, {DIST_NODES} ranks: {s20:.3f} s = "
        f"{s20 * 1e6 / E:.4f} us/edge on the ranks (one card, torch "
        f"backend: {main_seconds:.3f} s = {main_seconds * 1e6 / E:.4f} "
        f"us/edge); rf {st['rf']:.4f} (one card {main_res.stats['rf']:.4f}, "
        f"random {rf_random:.4f}), balance {st['balance']:.4f}, m_cap "
        f"{st['m_cap']}, cap retries {st['cap_retries']}; {note}")
    del res, runs

    # one rank over NCCL (the sharded partitioner's NCCL path) while the
    # k = 8 partition below is made; then the per-rank engine on 8 ranks
    nccl_run = pool.submit(sharded, g16, cfg, nodes=1,
                           mesh=make_stream_mesh(1))
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig.optimized(
        DIST_GAS_K, restream=1), backend="torch", iters=DIST_ITERS))
    sess.partition(g.src, g.dst, V).layout()
    lay = sess.partition_layout
    t, wall = time.perf_counter(), time.time()
    runs = run_on_ranks(dist_gas_job, make_graph_mesh(DIST_GAS_K), sess,
                        timeout=600)
    s_ranks = time.perf_counter() - t
    s_start = runs["started"] - wall
    t = time.perf_counter()

    def stacked(name, ex, **kw):
        return eng.simulate_gas(eng.get_program(name, V), lay,
                                kw.pop("iters", DIST_ITERS), ex, **kw)

    for ex in DIST_WIRES:
        for name in ("pagerank", "cc"):
            got, reports = runs[ex, name]
            want = stacked(name, ex)
            lossy = name == "pagerank" and ex in DIST_LOSSY
            if name == "cc":
                check(np.array_equal(got, want), f"[dist] cc on {ex}: the "
                      "ranks differ from the stacked engine")
                err = "equal to the stacked engine"
            elif lossy:
                e = float(np.abs(got.astype(np.float64) - pr_ref).max())
                check(e < DIST_LOSSY_BOUND, f"[dist] pagerank on {ex}: max "
                      f"|d| {e:.3e} to the oracle")
                err = f"max |d| to the float64 oracle {e:.3e}"
            else:
                check(np.allclose(got, want, rtol=1e-5, atol=0.0),
                      f"[dist] pagerank on {ex}: not within rtol 1e-5 of "
                      "the stacked engine")
                rel = np.abs(got / np.maximum(want, 1e-30) - 1).max()
                err = f"max rel |d| to the stacked engine {float(rel):.2e}"
            dist_check_k3(reports, 1 if name == "pagerank" else 0,
                          DIST_ITERS, f"{name} on {ex}")
            site = ex if name == "pagerank" or ex not in DIST_LOSSY else \
                {"quantized": "halo", "ragged_quantized": "ragged"}[ex]
            counted = sum(w["collectives"][f"{site}.{p}"]["bytes"]
                          for w in reports for p in ("reduce", "broadcast"))
            model = lay.comm_bytes(ex, lossy=name == "pagerank")
            per_iter = counted / DIST_ITERS
            want_b = model * (DIST_GAS_K - 1) / DIST_GAS_K \
                if ex == "dense" else model
            check(per_iter == want_b, f"[dist] {name} on {ex}: counted "
                  f"{per_iter} bytes an iteration, model {model}")
            ms = 1e3 * max(w["loop_seconds"] for w in reports) / DIST_ITERS
            log(f"[dist] {name} on {ex}, {DIST_GAS_K} ranks: {ms:.3f} "
                f"ms/iteration over gloo on this one card (the transport, "
                f"not a network); {per_iter:.0f} bytes an iteration counted "
                f"on the wire against comm_bytes {model}"
                + (" (the model counts the block a rank gathers from "
                   "itself)" if ex == "dense" else "")
                + f"; {err}")
    gots, reports = runs["bundle"]
    for name, got, want in zip(GAS_F32_BUNDLE, gots, eng.simulate_gas_many(
            [eng.get_program(p, V) for p in GAS_F32_BUNDLE], lay,
            DIST_ITERS, "halo")):
        check(np.allclose(got, want, rtol=1e-5, atol=0.0),
              f"[dist] fused {name}: not within rtol 1e-5")
    dist_check_k3(reports, len(GAS_F32_BUNDLE), DIST_ITERS, "the fused bundle")
    ms_b = 1e3 * max(w["loop_seconds"] for w in reports) / DIST_ITERS
    (got, it, reports) = runs["tol"]
    want, want_it = stacked("pagerank", "halo", iters=GAS_CAP, tol=PR_TOL,
                            return_iters=True)
    check(abs(it - want_it) <= 1, f"[dist] tol: {it} iterations on the "
          f"ranks, {want_it} stacked")
    check(np.allclose(got, want, rtol=1e-5, atol=0.0),
          "[dist] tol: not within rtol 1e-5")
    dist_check_k3(reports, 1, it, "pagerank to tol")
    got, reports = runs["overlap"]
    check(np.allclose(got, stacked("pagerank", "ragged", overlap=True),
                      rtol=1e-5, atol=0.0), "[dist] overlap on ragged: not "
          "within rtol 1e-5")
    ms_o = 1e3 * max(w["loop_seconds"] for w in reports) / DIST_ITERS
    log(f"[dist] fused (pagerank, ppr, centrality) on halo {ms_b:.3f} "
        f"ms/iteration; pagerank to tol {PR_TOL:g} in {it} iterations "
        f"(stacked {want_it}); overlap on ragged {ms_o:.3f} ms/iteration; "
        f"the spawn and every run {s_ranks:.1f} s ({s_start:.1f} s until "
        f"every rank ran), the stacked checks "
        f"{time.perf_counter() - t:.1f} s; {note}")
    keys = [(ex, n) for ex in DIST_WIRES for n in ("pagerank", "cc")]
    k3 = {"ranks": sum(w["launches"].get("ell_spmv", 0)
                       for key in keys + ["bundle", "tol", "overlap"]
                       for w in runs[key][-1])}
    k3["dryrun"] = dryrun_phase(sess, runs["dryrun"], runs["dryrun_s"])
    del sess, lay, runs

    one, s_one = nccl_run.result()
    pool.shutdown()
    check(one.stats["mesh"]["transport"] == "nccl",
          f"[dist] the one-rank run used {one.stats['mesh']}")
    check(one.stats["balance"] <= cfg.tau + 0.05, "[dist] nccl: balance")
    dist_check_partition_launches(one, True, "[dist] nccl")
    log(f"[dist] scale {SMALL_SCALE} on 1 rank over nccl: rf "
        f"{one.stats['rf']:.4f}, {s_one:.2f} s (several cards over NCCL: "
        f"not run, one card here)")
    log(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")
    return k3


# ---------------------------------------------------------------------------
# the LM half of the mesh as ranks on one card: qwen2-7b served tensor- and
# sequence-parallel over make_test_mesh(2, 4), then pipeline stages

MESH_DATA, MESH_MODEL = 2, 4         # make_test_mesh(2, 4): 8 ranks
MESH_F32_STEPS = 4                   # decode steps of the f32 check
# [lm-mesh] serves qwen2-7b's first 4 of its 28 layers (all 28 until
# [family-mesh] joined: cut for the script's time), held to the one
# card's run of the same 4 layers
LM_MESH_LAYERS = 4
# the prompt's first tokens the decode takes ([serve]'s 16 until the
# dry twins joined the mesh phases, cut for the script's time) and the
# greedy tokens after them ([serve]'s 32; 16 until the graph dry-run
# joined [dist]); Smax = 8 keeps 2 cache rows a model rank
LM_MESH_PROMPT = 4
MESH_TOKENS = 4
# the mesh's bf16 distance to the f32 twin over the one card's (the ratio
# read 1.030 on the prefill logits and 0.975 after the prompt in this
# phase on an H100 80GB HBM3 at 700 W; the limit leaves a fifth of slack)
MESH_NOISE = 1.2
PP_STAGES, PP_MICRO = 4, 4           # pipeline stages, microbatches
# layers a stage (7 until [family-mesh] joined: qwen2's 28 layers; cut for
# the script's time)
PP_LAYERS = 2
CHECKSUM_CHUNK = 1 << 24


def checksum(torch, x) -> int:
    """An exact checksum of a tensor's bits, sensitive to their order:
    Σ_i bits_i · (i mod 65521 + 1) in int64 (wrapping), by chunks."""
    flat = x.contiguous().view(-1)
    bits = flat.view(torch.int16 if flat.element_size() == 2
                     else torch.int32)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for at in range(0, bits.numel(), CHECKSUM_CHUNK):
        part = bits[at:at + CHECKSUM_CHUNK].to(torch.int64)
        w = torch.arange(at, at + part.numel(), device=x.device) % 65521 + 1
        total += (part * w).sum()
    return int(total)


def mesh_checksums(torch, params, zero: bool = False) -> dict:
    """The checksum of every leaf's block on each model rank of
    make_test_mesh(MESH_DATA, MESH_MODEL) (the blocks ``place_params``
    keeps; the data axis holds copies), from the one-card tree; with
    ``zero`` (ZeRO-3: the blocks differ on the data axis too) on every
    rank of the mesh, by global rank."""
    import dataclasses
    from repro_torch.dist.sharding import block
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.shardings import (map_with_path, param_specs,
                                             sanitize_specs)
    spec = make_test_mesh(MESH_DATA, MESH_MODEL, device="cpu")
    ranks = [dataclasses.replace(spec, rank=r)
             for r in range(spec.size if zero else MESH_MODEL)]
    specs = sanitize_specs(param_specs(params, zero=zero, multi_pod=False),
                           params, spec.shape)
    leaves = {}
    map_with_path(lambda path, x: leaves.__setitem__(path, x), params)
    flat = {}
    map_with_path(lambda path, s: flat.__setitem__(path, s), specs)
    return {path: [checksum(torch, block(x, flat[path], r)) for r in ranks]
            for path, x in leaves.items()}


def f32_twin(torch, cfg, params, tokens, prompt) -> dict:
    """The bf16 tree's exact f32 copy: its prefill logits on ``tokens`` and
    its logits after ``prompt`` by the decode loop, on the host, and how
    far the bf16 run's are from them (of the largest |logit|)."""
    from repro_torch.launch.serve import generate
    from repro_torch.train import make_prefill_step
    from repro_torch.train.optimizer import tree_map
    p32 = tree_map(lambda t: t.float(), params)
    twin = dict(twin_logits=make_prefill_step(cfg, dtype=torch.float32)(
        p32, {"tokens": tokens}).cpu(), twin_prompt_logits=generate(
            p32, cfg, prompt, 1, dtype=torch.float32).prompt_logits.cpu())
    del p32
    torch.cuda.empty_cache()
    return twin


def lm_mesh_witness(torch, cfg, params, tokens, prompt) -> dict:
    """``[lm-mesh]``'s witness from phase 6's bf16 tree: its first
    LM_MESH_LAYERS layers (the cut model's seed-0 draws), their prefill
    logits on ``tokens`` and greedy decode after ``prompt``'s first
    LM_MESH_PROMPT tokens on the one card, the checksums of the blocks
    each model rank keeps, and the same weights' f32 twin (the one card's
    own bf16 error), on the host."""
    import dataclasses
    from repro_torch.launch.serve import generate
    from repro_torch.train import make_prefill_step
    prompt = prompt[:, :LM_MESH_PROMPT]
    cut = dataclasses.replace(cfg, n_layers=LM_MESH_LAYERS)
    p = dict(params, g_dense=params["g_dense"][:LM_MESH_LAYERS])
    served = generate(p, cut, prompt, MESH_TOKENS, dtype=torch.bfloat16)
    out = dict(tokens=tokens.cpu(), prompt=prompt.cpu(),
               logits=make_prefill_step(cut, dtype=torch.bfloat16)(
                   p, {"tokens": tokens}).float().cpu(),
               served_tokens=served.tokens.cpu(),
               prompt_logits=served.prompt_logits.float().cpu(),
               checksums=mesh_checksums(torch, p))
    out.update(f32_twin(torch, cut, p, tokens, prompt))
    return out


def mesh_probe(smax: int) -> list:
    """One cache position in each model rank's block of ``smax`` rows: the
    first rank's first row, the last rank's last, others between."""
    rows = smax // MESH_MODEL
    return [m * rows + (rows - 1) * m // (MESH_MODEL - 1)
            for m in range(MESH_MODEL)]


def meta_like(torch, tree):
    """Meta tensors of ``tree``'s shapes and dtypes (a tensor or a dict)."""
    return tree_like(tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                 device="meta"))


def dry_start(jobs):
    """Start, in a thread, the dry twins of a rank job's counted windows:
    for each ``(mesh, draw, windows)`` of ``jobs``, as this rank of
    ``mesh`` under ``collectives.dry`` on the meta device (the thread's
    own counts; the rank's real calls keep counting into the process's),
    ``draw(dm)`` makes the rank's arguments (a dict, its "params" drawn
    and cut as the real rank's) and each ``(name, fn, peak)`` of
    ``windows`` runs ``fn(args)`` with the dry counts zeroed before and
    read after, under ``launch.dryrun.measure``'s meter where ``peak``.
    Torch's meta kernels are Python (≈ 150 µs an op, the meter ≈ 40% on
    top, and ≈ 5 s of a core to load on first use on the card's host),
    so the job starts the twin before its untimed f32 check and joins it
    (``dry_join``) before its first timed window, and the long decode
    windows run without the meter."""
    import threading
    import traceback
    box = {}

    def run():
        from repro_torch.dist import collectives as coll
        from repro_torch.dist.sharding import SINGLE_POD_RULES, use_rules
        from repro_torch.launch.dryrun import by_site, measure, nbytes
        try:
            t, out = time.perf_counter(), []
            for mesh, draw, windows in jobs:
                with coll.dry(mesh, mesh.coords) as dm, \
                        use_rules(SINGLE_POD_RULES, dm):
                    args = draw(dm)
                    res = {"weight_bytes": nbytes(args["params"])}
                    for name, fn, peak in windows:
                        coll.reset_counts()
                        gib = None
                        if peak:
                            _r, m = measure(fn, (args,), flops=False)
                            gib = (res["weight_bytes"]
                                   + m["temp_bytes"]) / 2**30
                        else:
                            fn(args)
                        res[name] = (by_site(coll.counts()), gib)
                out.append(res)
                del args
            box["out"], box["s"] = out, time.perf_counter() - t
        except BaseException:   # noqa: BLE001 — raised again by dry_join
            box["error"] = traceback.format_exc()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, box


def dry_join(twin):
    """The twins' results (``dry_start``), once its thread has ended;
    raises with the thread's traceback if a twin failed."""
    thread, box = twin
    t = time.perf_counter()
    thread.join()
    if "error" in box:
        raise RuntimeError(f"the dry twin failed:\n{box['error']}")
    box.setdefault("wait_s", time.perf_counter() - t)
    return box


def dry_report(twin, i, real) -> dict:
    """Twin ``i``'s windows held against ``real``, ``{name: (the real
    window's collectives.counts(), its max_memory_allocated in GiB)}``:
    each window's verdict (bytes, calls and ops by site equal), differing
    sites, calls, and the dry peak estimate (the parameters plus
    ``launch.dryrun.measure``'s temp bytes; None where the window ran
    without the meter) beside the real one; the
    parameter bytes; the twin's seconds in its thread and the seconds the
    job waited for it."""
    from repro_torch.launch.dryrun import by_site
    box = dry_join(twin)
    dry = box["out"][i]
    out = {"weight_bytes": dry["weight_bytes"], "windows": {},
           "s": box["s"], "wait_s": box["wait_s"]}
    for name, (counts, peak_gib) in real.items():
        sites, dry_peak = dry[name]
        want = by_site(counts)
        out["windows"][name] = dict(
            equal=sites == want, calls=sum(c["calls"]
                                           for c in sites.values()),
            diff=sorted(x for x in set(sites) | set(want)
                        if sites.get(x) != want.get(x)),
            peak_gib=dry_peak, real_peak_gib=peak_gib)
    return out


def serving_twin(torch, mesh, cfg, batch, prompt, new_tokens,
                 memory=None):
    """``dry_start``'s job for a serving rank's two windows on ``mesh``:
    its bf16 blocks drawn on meta as ``place_params`` cuts them, the
    prefill step on ``batch`` (under the meter), then ``generate`` of
    ``prompt`` and ``new_tokens`` attending ``memory`` (without it); each
    input a meta tensor of the real one's shape."""
    from repro_torch.launch.dryrun import meta_generator
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step, place_params
    m_batch, m_prompt = meta_like(torch, batch), meta_like(torch, prompt)
    m_memory = None if memory is None else meta_like(torch, memory)
    return (mesh, lambda dm: {"params": lm.init_params(
        cfg, meta_generator(), dtype=torch.bfloat16,
        place=place_params(dm))}, [
        ("prefill", lambda a: make_prefill_step(
            cfg, dtype=torch.bfloat16)(a["params"], m_batch), True),
        ("decode", lambda a: generate(
            a["params"], cfg, m_prompt, new_tokens, dtype=torch.bfloat16,
            memory=m_memory), False)])


def dry_verdict(tag, reports, weight_key="weight_bytes") -> None:
    """``check`` every rank's ``dry_report``: each window's collectives by
    site and the parameter bytes equal the real rank's; the peaks logged
    beside each other, not gated."""
    for r in reports:
        d = r["dry"]
        check(d["weight_bytes"] == r[weight_key], f"{tag} rank "
              f"{r['coords']}: the dry run's parameter bytes "
              f"{d['weight_bytes']} != the rank's {r[weight_key]}")
        for name, w in d["windows"].items():
            check(w["equal"] and w["calls"], f"{tag} rank {r['coords']}: "
                  f"the dry {name}'s collectives differ from the real "
                  f"window's at {w['diff']} ({w['calls']} calls)")
    names = list(reports[0]["dry"]["windows"])

    def most(n, key):
        return max(r["dry"]["windows"][n][key] for r in reports)
    peaks = "; ".join(f"{n}: dry {most(n, 'peak_gib'):.2f} GiB, "
                      f"max_memory_allocated {most(n, 'real_peak_gib'):.2f}"
                      " GiB" for n in names
                      if reports[0]["dry"]["windows"][n]["peak_gib"]
                      is not None)
    log(f"{tag} dry = real: every rank's {' and '.join(names)} run again as "
        "that rank on the meta device (collectives.dry) hand the same "
        "bytes, calls and ops by site as its real window, and its "
        f"{reports[0]['dry']['weight_bytes']} B of parameters equal the "
        "rank's; the job's dry twins (every model of it) "
        f"{max(r['dry']['s'] for r in reports):.2f} s a rank in their "
        "thread beside its untimed work, the job waited "
        f"{max(r['dry']['wait_s'] for r in reports):.2f} s for them; peak "
        f"a rank (the largest, estimate not gated) {peaks}")


def lm_mesh_job(mesh, cfg, f32_cfg, tokens, f32_tokens, prompt, new_tokens):
    """``[lm-mesh]`` on one rank of make_test_mesh(2, 4) (SPMD): the f32
    check at full width on 2 layers (prefill logits and MESH_F32_STEPS
    decode steps, gathered whole), then qwen2-7b at full width and
    LM_MESH_LAYERS layers in bf16 from the card generator's seed-0 draws
    (every draw of the one-card tree replayed, this rank's blocks kept):
    the checksums of its
    blocks, a warm-up and a timed prefill (K4 counted), a warm-up of the
    decode step (``make_decode_fn``) at the ``mesh_probe`` positions of a
    cache of the serving run's rows, which reports this rank's block of
    that cache and the positions written in it, then ``generate``.  Rank
    0 returns the
    gathered values; every rank's report comes through
    ``gather_objects``."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import (SINGLE_POD_RULES, active_spec,
                                           shard, unshard, use_rules)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.train import (make_decode_fn, make_prefill_step,
                                   place_params)
    from repro_torch.train.shardings import map_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {"started": float(coll.pmax(torch.tensor(
        [time.time()], dtype=torch.float64), mesh))}
    report = {"coords": mesh.coords}
    twin = dry_start([serving_twin(torch, mesh, cfg, {"tokens": tokens},
                                   prompt, new_tokens)])
    with use_rules(SINGLE_POD_RULES, mesh):
        # f32, 2 layers at full width: the mesh against the one card
        p32 = lm.init_params(f32_cfg, torch.Generator(device=dev)
                             .manual_seed(1), place=place_params(mesh))
        toks = f32_tokens.to(dev)
        out["f32_logits"] = make_prefill_step(f32_cfg, dtype=torch.float32)(
            p32, {"tokens": toks})
        B = toks.shape[0]
        spec = active_spec((B,), "batch")
        cache = lm.init_cache(f32_cfg, B, MESH_F32_STEPS,
                              dtype=torch.float32, device=dev)
        step = make_decode_fn(f32_cfg, dtype=torch.float32,
                              max_len=MESH_F32_STEPS)
        tp = lm.tensor_parallel(f32_cfg)
        mine = shard(toks, "batch", None)
        steps = []
        for t in range(MESH_F32_STEPS):
            logits, cache = step(p32, cache, mine[:, t:t + 1], t)
            (logits,) = lm.L.gather_cols([logits], tp.axis(tp.vocab),
                                         site="check")
            steps.append(unshard(logits, spec + (None, None), mesh))
        out["f32_steps"] = torch.cat(steps, 1)
        del p32, cache, logits, steps
        torch.cuda.empty_cache()

        # bf16 at full width, LM_MESH_LAYERS layers
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), dtype=torch.bfloat16,
                                place=place_params(mesh))
        torch.cuda.synchronize(dev)
        report["init_s"] = time.perf_counter() - t
        report["init_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        sums = {}
        map_with_path(lambda path, x: sums.__setitem__(
            path, checksum(torch, x)), params)
        report["checksums"] = sums
        report["weight_bytes"] = sum(x.numel() * x.element_size()
                                     for x in lm.tree_leaves(params))
        toks = tokens.to(dev)
        prefill_step = make_prefill_step(cfg, dtype=torch.bfloat16)
        dry_join(twin)              # before the first timed window
        prefill_step(params, {"tokens": toks})            # warm-up
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        coll.reset_counts()
        ops.reset_launch_counts()
        t = time.perf_counter()
        logits = prefill_step(params, {"tokens": toks})
        torch.cuda.synchronize(dev)
        report["prefill_s"] = time.perf_counter() - t
        report["prefill_launches"] = ops.launch_counts()
        report["prefill_collectives"] = coll.counts()
        report["prefill_peak_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
        out["logits"] = logits

        # the decode step's warm-up: one step at each ``mesh_probe``
        # position of the serving run's cache, each written by its owner
        prompt = prompt.to(dev)
        smax = prompt.shape[1] + new_tokens
        cache = lm.init_cache(cfg, prompt.shape[0], smax,
                              dtype=torch.bfloat16, device=dev)
        step = make_decode_fn(cfg, dtype=torch.bfloat16, max_len=smax)
        mine = shard(prompt, "batch", None)
        for i, at in enumerate(mesh_probe(smax)):
            step(params, cache, mine[:, i:i + 1], at)
        k = cache["dense"]["k"]
        report["cache_shape"] = tuple(k.shape)
        written = (k.abs().amax(dim=(0, 1, 3, 4)) > 0).nonzero()[:, 0]
        report["written"] = (written + mesh.coords["model"] * k.shape[2]) \
            .tolist()
        del cache, k
        torch.cuda.reset_peak_memory_stats(dev)
        coll.reset_counts()
        ops.reset_launch_counts()
        served = generate(params, cfg, prompt, new_tokens,
                          dtype=torch.bfloat16)
        report["decode_s"] = served.seconds
        report["decode_launches"] = ops.launch_counts()
        report["decode_collectives"] = coll.counts()
        report["decode_peak_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
        out["served"] = served
        report["dry"] = dry_report(twin, 0, {
            "prefill": (report["prefill_collectives"],
                        report["prefill_peak_gib"]),
            "decode": (report["decode_collectives"],
                       report["decode_peak_gib"])})
    out["reports"] = coll.gather_objects(report, mesh)
    return out


def k4_rank_times(torch, ops, F, q, k, v, causal=True) -> dict:
    """K4 and ``scaled_dot_product_attention`` on (q, k, v), each
    timed two ways: CUDA events around 20 back-to-back calls (which read
    the host's launch rate where a call is shorter than its launch) and
    the profiler's device time of a call; with the card's SM clock, its
    maximum, temperature and power draw as nvidia-smi reads them."""
    def k4():
        return ops.flash_attention(q, k, v, causal=causal)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    return dict(k4_events=event_ms(torch, k4, 20),
                k4_device=device_ms(torch, k4, 20, "flash_bf16_kernel"),
                sdpa_events=event_ms(torch, sdpa, 20),
                sdpa_device=device_ms(torch, sdpa, 20),
                card=smi("clocks.sm,clocks.max.sm,temperature.gpu,"
                         "power.draw"))


def lm_mesh_phase(torch, ops, dev, witness, k4_row) -> None:
    """``[lm-mesh]``: qwen2-7b (its first LM_MESH_LAYERS layers at full
    width) served tensor- and sequence-parallel over make_test_mesh(2,
    4), 8 ranks sharing this card over gloo, held to the one card's run
    of the same layers (``witness``, from phase 6)."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.train import make_decode_fn, make_prefill_step

    t_phase = time.perf_counter()
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=LM_MESH_LAYERS)
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    rng = np.random.default_rng(3)
    f32_tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (
        SERVE_B, SERVE_PROMPT)))
    # the one card's f32 answer on the same weights (its seed-1 draws)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    toks = f32_tokens.to(dev)
    want_logits = make_prefill_step(small, dtype=torch.float32)(
        p32, {"tokens": toks})
    cache = init_cache(small, SERVE_B, MESH_F32_STEPS, dtype=torch.float32,
                       device=dev)
    step = make_decode_fn(small, dtype=torch.float32)
    want_steps = []
    for t in range(MESH_F32_STEPS):
        logits, cache = step(p32, cache, toks[:, t:t + 1], t)
        want_steps.append(logits)
    want_steps = torch.cat(want_steps, 1)
    del p32, cache, logits
    torch.cuda.empty_cache()

    # K4 at the rank's shape, alone on the card, before the ranks start
    gen = torch.Generator(device=dev).manual_seed(4)
    B, Hq, Hkv = PREFILL_B // MESH_DATA, cfg.n_heads // MESH_MODEL, \
        cfg.n_kv_heads // MESH_MODEL
    q = torch.randn(B, Hq, PREFILL_S, cfg.hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B, Hkv, PREFILL_S, cfg.hd, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    err, _err_r, _ms, plain, _lib, _got = k4_yardstick(torch, ops, F, q, k,
                                                       v, True)
    before = k4_rank_times(torch, ops, F, q, k, v)
    log(f"[K4] the rank's shape before the ranks start: {before}")

    note = ("ranks share this one card over gloo (staged through host "
            "memory): these times measure that transport, not an "
            "interconnect")
    t, wall = time.perf_counter(), time.time()
    out = run_on_ranks(lm_mesh_job, make_test_mesh(MESH_DATA, MESH_MODEL),
                       cfg, small, witness["tokens"], f32_tokens,
                       witness["prompt"], MESH_TOKENS, timeout=600)
    s_spawn = time.perf_counter() - t
    reports = out["reports"]
    log(f"[lm-mesh] {len(reports)} ranks of make_test_mesh({MESH_DATA}, "
        f"{MESH_MODEL}) on this card over gloo in one spawn: {s_spawn:.1f} "
        f"s, of which {out['started'] - wall:.1f} s until every rank ran")
    dry_verdict("[lm-mesh]", reports)

    def rel(got, want):
        return float((got.float().cpu() - want.float().cpu()).abs().max()
                     / want.float().abs().max())

    e_pre = rel(out["f32_logits"], want_logits)
    e_dec = rel(out["f32_steps"], want_steps)
    check(e_pre <= 1e-4 and e_dec <= 1e-4, f"[lm-mesh] f32: the mesh's "
          f"logits are {e_pre:.3e} (prefill) and {e_dec:.3e} (decode) of "
          "the largest from the one card's")
    log(f"[lm-mesh] f32, {CHECK_LAYERS} layers at full width, B={SERVE_B}: "
        f"prefill logits {e_pre:.3e} and {MESH_F32_STEPS} decode steps' "
        f"logits {e_dec:.3e} of the largest |logit| from the one card's on "
        "the same weights (tolerance 1e-4)")

    # the blocks are the one-card tree's
    for r in reports:
        m = r["coords"]["model"]
        bad = [p for p, c in r["checksums"].items()
               if c != witness["checksums"][p][m]]
        check(not bad, f"[lm-mesh] rank {r['coords']}: blocks differ from "
              f"the one-card tree at {bad[:3]}")
    log(f"[lm-mesh] every rank's {len(reports[0]['checksums'])} blocks "
        "equal the one-card tree's ([serve]'s seed-0 draws, its first "
        f"{LM_MESH_LAYERS} layers) by checksum; "
        f"per rank {reports[0]['weight_bytes'] / 1e9:.3f} GB of weights, "
        f"built in {max(r['init_s'] for r in reports):.1f} s (peak "
        f"{max(r['init_peak_gib'] for r in reports):.2f} GiB)")

    # K4 once a layer a rank, at the rank's shape; no kernel in decode
    for r in reports:
        got = {k: v for k, v in r["prefill_launches"].items() if v}
        check(got == {"flash_attention": cfg.n_layers}, f"[lm-mesh] rank "
              f"{r['coords']} prefill launched {got}, not K4 "
              f"{cfg.n_layers} times")
        check(not any(r["decode_launches"].values()), f"[lm-mesh] rank "
              f"{r['coords']} decode launched {r['decode_launches']}")
    launches = sum(r["prefill_launches"]["flash_attention"] for r in reports)
    logits, served = out["logits"], out["served"]
    check(logits.shape == (PREFILL_B, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "[lm-mesh] prefill logits")
    check(served.finite and served.tokens.shape == (SERVE_B, MESH_TOKENS)
          and int(served.tokens.max()) < cfg.vocab, "[lm-mesh] decode output")
    # the first step (the prefill) against the one card's at the same depth
    # within 2e-2; the mesh's
    # and the one card's bf16 runs against the same weights' f32 twin: the
    # mesh no farther than MESH_NOISE times the one card (two bf16 runs
    # differ by up to twice that error, so the logits after the prompt are
    # held to the twin, and their distance to the one card's is logged)
    e_pre = rel(logits, witness["logits"])
    e_first = rel(served.prompt_logits, witness["prompt_logits"])
    noise = (rel(witness["logits"], witness["twin_logits"]),
             rel(witness["prompt_logits"], witness["twin_prompt_logits"]))
    mesh = (rel(logits, witness["twin_logits"]),
            rel(served.prompt_logits, witness["twin_prompt_logits"]))
    check(e_pre <= 2e-2, f"[lm-mesh] bf16: prefill logits {e_pre:.3e} of "
          "the largest from the one card's")
    check(all(m <= MESH_NOISE * n for m, n in zip(mesh, noise)),
          f"[lm-mesh] bf16 against the f32 twin: the mesh {mesh}, the one "
          f"card {noise}")
    log(f"[lm-mesh] bf16 against the same weights' f32 twin (of the largest "
        f"|logit|): prefill logits the one card {noise[0]:.3e}, the mesh "
        f"{mesh[0]:.3e}; logits after the prompt the one card "
        f"{noise[1]:.3e}, the mesh {mesh[1]:.3e} (held within "
        f"{MESH_NOISE}x the one card's); mesh to the one card's after the "
        f"prompt {e_first:.3e} (logged)")
    agree = int((served.tokens.cpu()
                 == witness["served_tokens"][:, :MESH_TOKENS]).sum())
    t_pre = max(r["prefill_s"] for r in reports)
    log(f"[lm-mesh] bf16 {cfg.name}, {cfg.n_layers} of its {full.n_layers} "
        f"layers at full width (cut for the script's time): "
        f"prefill {PREFILL_B} x {PREFILL_S} ({PREFILL_B // MESH_DATA} rows a "
        f"data rank) {t_pre * 1e3:.1f} ms = "
        f"{PREFILL_B * PREFILL_S / t_pre:.1f} tokens/s (the slowest rank); "
        f"logits {e_pre:.3e} of the largest |logit| from the one card's "
        f"prefill of the same layers (tolerance 2e-2); "
        f"K4 {cfg.n_layers} launches a rank at ({PREFILL_B // MESH_DATA}, "
        f"{cfg.n_heads // MESH_MODEL}/{cfg.n_kv_heads // MESH_MODEL}, "
        f"{PREFILL_S}, {cfg.hd}), {launches} in all; {note}")
    ms_step = max(r["decode_s"] for r in reports) * 1e3 / served.steps
    log(f"[lm-mesh] decode B={SERVE_B}, prompt {LM_MESH_PROMPT} + "
        f"{MESH_TOKENS} greedy tokens (cut from [serve]'s {SERVE_TOKENS} "
        f"for time): {ms_step:.3f} ms/token-step (the "
        f"slowest rank); {agree} of {served.tokens.numel()} greedy tokens "
        f"equal the one card's (near-ties of random weights, not gated); "
        f"first "
        f"tokens {served.tokens[0][:16].tolist()}")
    smax = LM_MESH_PROMPT + MESH_TOKENS
    rows = smax // MESH_MODEL
    for r in reports:
        m = r["coords"]["model"]
        check(r["cache_shape"] == (cfg.n_layers, SERVE_B // MESH_DATA, rows,
                                   cfg.n_kv_heads, cfg.hd),
              f"[lm-mesh] rank {r['coords']} cache {r['cache_shape']}")
        want = [p for p in mesh_probe(smax) if p // rows == m]
        check(len(want) == 1 and r["written"] == want, f"[lm-mesh] rank "
              f"{r['coords']} wrote positions {r['written']}, owns {want} "
              f"of {mesh_probe(smax)}")
    log(f"[lm-mesh] each rank's cache block (layers, B/2, Smax/4, Hkv, Dh) "
        f"= {reports[0]['cache_shape']}: positions {rows}·m .. {rows}·m + "
        f"{rows - 1} of {smax} on model rank m; decode steps at positions "
        f"{mesh_probe(smax)} wrote each into its owner's block alone")
    for r in reports:
        sites = {phase: {site: (round(c["seconds"], 4), c["bytes"],
                                c["calls"])
                         for site, c in r[f"{phase}_collectives"].items()}
                 for phase in ("prefill", "decode")}
        log(f"[lm-mesh] rank {r['coords']}: prefill {r['prefill_s']:.3f} s, "
            f"decode {r['decode_s']:.3f} s, peak {r['prefill_peak_gib']:.2f} "
            f"/ {r['decode_peak_gib']:.2f} GiB; collectives (seconds, "
            f"bytes, calls) by site {json.dumps(sites)}")

    # K4 at the rank's shape, alone on the card, against SDPA, after the
    # ranks have exited
    after = k4_rank_times(torch, ops, F, q, k, v)
    log(f"[K4] the rank's shape after the ranks exited: {after}")
    pairs = PREFILL_S * (PREFILL_S + 1) // 2
    flops = 4 * cfg.hd * pairs * B * Hq
    bms, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), flops,
                       BF16_OPS_PER_S)
    ms, lib = before["k4_device"], before["sdpa_device"]
    k4_row["launches"] += launches
    k4_row["mesh_shape"] = dict(shape=[B, Hq, Hkv, PREFILL_S, cfg.hd],
                                launches=launches, max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=bms, bound_by=by,
                                library_ms=lib, timed_by=timed_by(ms, lib))
    log(f"[K4] the rank's shape q {tuple(q.shape)} k/v {tuple(k.shape)}: "
        f"max |d| {err:.3e}; device time {ms:.4f} ms/launch = "
        f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of it; plain {plain:.3f} ms; "
        f"scaled_dot_product_attention device time {lib:.4f} ms (before "
        f"the spawn; CUDA events around back-to-back calls read K4 "
        f"{before['k4_events']:.4f} / {after['k4_events']:.4f} ms and SDPA "
        f"{before['sdpa_events']:.4f} / {after['sdpa_events']:.4f} ms "
        f"before / after the ranks, device time K4 "
        f"{after['k4_device']:.4f} ms and SDPA {after['sdpa_device']:.4f} "
        f"ms after)")
    log(f"[lm-mesh] phase {time.perf_counter() - t_phase:.1f} s")


def pp_layers(torch, cfg, dev, first, count, dtype):
    """Layers first..first + count − 1 of the pipeline's model, layer i
    drawn from its own card generator (seed 100 + i), so a stage's rank
    and the one-rank reference draw the same."""
    from repro_torch.models.lm import init_layer
    return [init_layer(cfg, "dense", torch.Generator(device=dev)
                       .manual_seed(100 + i), dtype)
            for i in range(first, first + count)]


def pp_inputs(torch, cfg, dev, dtype):
    """M microbatches of (1, PREFILL_S, d_model) hidden states."""
    gen = torch.Generator(device=dev).manual_seed(7)
    return torch.randn(PP_MICRO, 1, PREFILL_S, cfg.d_model, generator=gen,
                       device=dev, dtype=dtype)


def pp_job(mesh, cfg, f32_layers):
    """``[pp]`` on one stage rank: ``pipeline_apply`` of the f32 check
    (``f32_layers`` a stage) and of the bf16 model at full depth (28 / S
    layers a stage), a warm-up and a timed run, K4 counted."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.pipeline_parallel import pipeline_apply
    from repro_torch.kernels import ops
    from repro_torch.models.lm import run_layers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, S, s = mesh.device, mesh.size, mesh.rank

    def fn(x, layers):
        return run_layers(x, layers, cfg)

    def stages(count, dtype):
        return [pp_layers(torch, cfg, dev, s * count, count, dtype)
                if r == s else None for r in range(S)]

    out = {"f32": pipeline_apply(mesh, "stage", stages(f32_layers,
                                                       torch.float32),
                                 pp_inputs(torch, cfg, dev, torch.float32),
                                 fn)}
    torch.cuda.empty_cache()
    per = cfg.n_layers // S
    params = stages(per, torch.bfloat16)
    xs = pp_inputs(torch, cfg, dev, torch.bfloat16)
    pipeline_apply(mesh, "stage", params, xs, fn)             # warm-up
    torch.cuda.synchronize(dev)
    coll.reset_counts()
    ops.reset_launch_counts()
    t = time.perf_counter()
    out["bf16"] = pipeline_apply(mesh, "stage", params, xs, fn)
    torch.cuda.synchronize(dev)
    report = {"stage": s, "seconds": time.perf_counter() - t,
              "launches": ops.launch_counts(), "collectives": coll.counts(),
              "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    out["reports"] = coll.gather_objects(report, mesh)
    return out


def pp_phase(torch, ops, dev, k4_row) -> None:
    """``[pp]``: qwen2-7b's layers as PP_STAGES pipeline stages on ranks
    sharing this card, against ``reference_apply`` on one rank."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import make_mesh, run_on_ranks
    from repro_torch.dist.pipeline_parallel import reference_apply
    from repro_torch.models.lm import run_layers

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=PP_STAGES * PP_LAYERS)
    f32_layers = 1
    t = time.perf_counter()
    out = run_on_ranks(pp_job, make_mesh({"stage": PP_STAGES}), cfg,
                       f32_layers, timeout=600)
    s_spawn = time.perf_counter() - t
    reports = out["reports"]
    per = cfg.n_layers // PP_STAGES

    def fn(x, layers):
        return run_layers(x, layers, cfg)

    small = dataclasses.replace(cfg, n_layers=PP_STAGES * f32_layers)
    want = reference_apply(
        [pp_layers(torch, small, dev, i * f32_layers, f32_layers,
                   torch.float32) for i in range(PP_STAGES)],
        pp_inputs(torch, cfg, dev, torch.float32), fn)
    e32 = float((out["f32"] - want).abs().max() / want.abs().max())
    check(e32 <= 1e-4, f"[pp] f32: {e32:.3e} of the largest |h| from "
          "reference_apply")
    log(f"[pp] f32, {PP_STAGES} stages of {f32_layers} layer at full width, "
        f"{PP_MICRO} microbatches of (1, {PREFILL_S}, {cfg.d_model}): "
        f"{e32:.3e} of the largest |h| from reference_apply on one rank "
        f"(tolerance 1e-4; {'bit-equal' if e32 == 0 else 'not bit-equal'})")
    del want
    stages = [pp_layers(torch, cfg, dev, i * per, per, torch.bfloat16)
              for i in range(PP_STAGES)]
    xs = pp_inputs(torch, cfg, dev, torch.bfloat16)
    reference_apply(stages, xs, fn)                         # warm-up
    ms_ref = host_ms(torch, lambda: reference_apply(stages, xs, fn))
    want = reference_apply(stages, xs, fn)
    e16 = float((out["bf16"].float() - want.float()).abs().max()
                / want.float().abs().max())
    check(e16 <= 2e-2, f"[pp] bf16: {e16:.3e} of the largest |h|")
    del stages, want
    torch.cuda.empty_cache()
    for r in reports:
        got = {k: v for k, v in r["launches"].items() if v}
        check(got == {"flash_attention": per * PP_MICRO}, f"[pp] stage "
              f"{r['stage']} launched {got}, not K4 {per} times a "
              "microbatch")
    ticks = PP_MICRO + PP_STAGES - 1
    ms = max(r["seconds"] for r in reports) * 1e3
    hop = reports[0]["collectives"]["pipeline.hop"]
    check(hop["calls"] == ticks, f"[pp] {hop['calls']} ring hops, not "
          f"{ticks}")
    launches = sum(r["launches"]["flash_attention"] for r in reports)
    k4_row["launches"] += launches
    log(f"[pp] bf16 {cfg.name}: {PP_STAGES} stages of {per} layers, "
        f"{PP_MICRO} microbatches of (1, {PREFILL_S}) in {ticks} ticks "
        f"(bubble (S-1)/(M+S-1) = {(PP_STAGES - 1) / ticks:.1%}): "
        f"{ms:.1f} ms a pipelined forward (the slowest stage; one rank's "
        f"reference_apply alone on the card {ms_ref:.1f} ms); {e16:.3e} of "
        f"the largest |h| from reference_apply (tolerance 2e-2; "
        f"{'bit-equal' if e16 == 0 else 'not bit-equal'}); K4 {per} a stage "
        f"a microbatch, {launches} in all; spawn and runs {s_spawn:.1f} s; "
        f"ranks share this card over gloo (the transport, not an "
        f"interconnect)")
    for r in reports:
        log(f"[pp] stage {r['stage']}: {r['seconds'] * 1e3:.1f} ms, peak "
            f"{r['peak_gib']:.2f} GiB; collectives (seconds, bytes, calls) "
            + json.dumps({k: (round(c["seconds"], 4), c["bytes"], c["calls"])
                          for k, c in r["collectives"].items()}))
    log(f"[pp] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# training over the mesh: stablelm-1.6b ZeRO-3 on make_test_mesh(2, 4); and
# llama4-scout served over it with its experts on "model"

# bf16 steps of the mesh (3 before the graph dry-run joined
# [dist]: cut for the script's time; step 0 makes the gradient checks,
# step 1 is timed)
TRAIN_MESH_STEPS = 2
# [train-mesh] trains stablelm's first 2 of its 24 layers (all 24 until
# [family-mesh] joined: cut for the script's time), held to the one card's
# run of the same 2 layers (``train_twin``)
TRAIN_MESH_LAYERS = 2
# the mesh's bf16 loss at each step within this of [train]'s, relative
# (every run on an H100 80GB HBM3 at 700 W: 2.77e-05, 9.00e-06, 3.33e-05)
TRAIN_MESH_LOSS_RTOL = 1e-3
# leaves of [train]'s tree held after the mesh's last step: a matrix cut
# on both axes in the first layer, the last layer's row-parallel down
# product, a norm scale whole on both axes (summed by grad.data), the
# final norm's bias and the vocab-parallel head; each within this share of
# [train]'s update at the same step, ‖mesh − one‖ / ‖one − init‖ (read
# after step 2 of 3: 1.00e-02, 6.17e-03, 4.21e-03, 4.10e-03, 5.86e-03 on
# an H100 80GB HBM3 at 700 W; a data-axis sum left out moves a leaf it
# feeds to 0.3–0.6 on the CPU at the reduced size, while the losses stay
# within 1e-4)
TRAIN_WITNESS = (("g_dense", 0, "attn", "q", "w"),
                 ("g_dense", -1, "ffn", "down", "w"),
                 ("g_dense", 0, "ln1", "scale"), ("ln_f", "bias"),
                 ("lm_head", "w"))
TRAIN_MESH_UPDATE_TOL = 0.05
# llama4-scout on the mesh: each data rank holds a whole copy of its model
# block, so 12 layers would need ≈ 114 GB over the 8 ranks; 4 ≈ 43.5 GB
# (served until [family-mesh] joined; 1 since, cut for the script's time).
# The f32 check at 1 layer (≈ 34 GB over the ranks)
MOE_MESH_LAYERS, MOE_MESH_F32_LAYERS = 1, 1
# the decode's prompt and greedy tokens (16 and 16 until the dry twin
# of the window joined the phase, cut for the script's time)
MOE_MESH_PROMPT, MOE_MESH_TOKENS = 4, 4
# the bf16 mesh's kept pairs in each MoE layer may differ from the one
# card's by this share of the layer's routed pairs: its rank-order sums
# round attention's output otherwise, so near-ties route to other experts
# (four runs on an H100 80GB HBM3 at 700 W read the same pairs: 1, 2, 10
# and 5 of 8,192 apart in layers 0–3, the largest 1.22e-3); the f32
# check's routing must equal the one card's
MOE_MESH_DROP_SLACK = 2e-3


def train_twin(torch, dev, cfg, steps) -> dict:
    """``[train]``'s run at ``cfg``'s depth on one card: the seed-0 tree
    (the first layers of ``[train]``'s), the checksums of the blocks each
    rank of the ZeRO-3 mesh keeps of it, then ``steps`` AdamW steps under
    ``[train]``'s schedule on its batches: the losses, and
    ``TRAIN_WITNESS``'s leaves before the first and after the last, on
    the host."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import init_params
    from repro_torch.profile import TRAIN_B, TRAIN_LR, TRAIN_S, TRAIN_STEPS
    from repro_torch.train import adamw, cosine_schedule, make_train_step
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    out = {"checksums": mesh_checksums(torch, params, zero=True),
           "init": [leaf_at(params, k).cpu() for k in TRAIN_WITNESS],
           "losses": []}
    opt = adamw(schedule=cosine_schedule(
        TRAIN_LR, warmup=TRAIN_STEPS // 10, total=TRAIN_STEPS))
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, dtype=torch.bfloat16)
    dcfg = DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_at(dcfg, i).items()}
        params, state, loss = step_fn(params, state, batch, i)
        out["losses"].append(loss.item())
    out["after"] = [leaf_at(params, k).cpu() for k in TRAIN_WITNESS]
    del params, state, batch, loss
    torch.cuda.empty_cache()
    return out


def train_mesh_job(mesh, cfg, small, grad_batch, steps, out_dir):
    """``[train-mesh]`` on one rank of make_test_mesh(2, 4) (SPMD), under
    ``SINGLE_POD_RULES`` with ZeRO-3 placement: the f32 gradient check at
    2 layers of full width (seed-1 draws; the loss and every gradient leaf,
    gathered whole by ``gather_tree``, saved by rank 0 to ``grads_path``
    for the parent), then stablelm at full width (TRAIN_MESH_LAYERS
    layers) in bf16 from
    the card generator's seed-0 draws (this rank's blocks kept): their
    checksums, ``steps`` AdamW steps under ``[train]``'s cosine schedule on
    ``batch_at``'s stream, each with the counts zeroed before and read
    after (K4, the collectives by site), every gradient leaf gathered at
    step 0 and tested on rank 0 (finite, non-zero), the ``TRAIN_WITNESS``
    leaves gathered after the last step and saved by rank 0 to
    ``out_dir``.  Every rank's report comes through ``gather_objects``."""
    import torch
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import SINGLE_POD_RULES, use_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import meta_generator
    from repro_torch.models import lm
    from repro_torch.profile import TRAIN_B, TRAIN_LR, TRAIN_S, TRAIN_STEPS
    from repro_torch.train import (adamw, cosine_schedule, gather_tree,
                                   make_grad_fn, make_train_step,
                                   place_params, placed_specs)
    from repro_torch.train.optimizer import Optimizer, tree_unflatten
    from repro_torch.train.shardings import map_with_path
    from repro_torch.train.step import mesh_axes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {"started": float(coll.pmax(torch.tensor(
        [time.time()], dtype=torch.float64), mesh))}
    report = {"coords": mesh.coords, "rank": mesh.rank}
    dcfg = DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    m_batch = meta_like(torch, {k: torch.from_numpy(v) for k, v in
                                batch_at(dcfg, 0).items()})

    def schedule():
        return cosine_schedule(TRAIN_LR, warmup=TRAIN_STEPS // 10,
                               total=TRAIN_STEPS)

    def dry_draw(dm):           # the rank's f32 masters, ZeRO-3, AdamW
        place = place_params(dm, zero=True)
        p = lm.init_params(cfg, meta_generator(), place=place)
        sp, opt = placed_specs(place), adamw(schedule=schedule())
        return {"params": p, "state": opt.init(p, axes=mesh_axes(sp)[1]),
                "step": make_train_step(cfg, opt, dtype=torch.bfloat16,
                                        specs=sp)}
    # the last step's window (step 0's also gathers every gradient leaf)
    twin = dry_start([(mesh, dry_draw, [(f"step {steps - 1}", lambda a: a[
        "step"](a["params"], a["state"], m_batch, steps - 1), True)])])
    with use_rules(SINGLE_POD_RULES, mesh):
        # f32, 2 layers at full width: the mesh against the one card
        place = place_params(mesh, zero=True)
        p32 = lm.init_params(small, torch.Generator(device=dev)
                             .manual_seed(1), place=place)
        specs = placed_specs(place)
        batch = {k: v.to(dev) for k, v in grad_batch.items()}
        ops.reset_launch_counts()
        t = time.perf_counter()
        loss, grads = make_grad_fn(small, dtype=torch.float32,
                                   specs=specs)(p32, batch)
        report["f32_launches"] = ops.launch_counts()
        whole = gather_tree(tree_unflatten(p32, grads), specs, mesh,
                            site="check.gather")
        if mesh.rank == 0:          # the others hold a tree of Nones
            torch.save({"loss": float(loss), "grads": [
                g.cpu() for g in lm.tree_leaves(whole)]},
                f"{out_dir}/grads.pt")
        report["f32_s"] = time.perf_counter() - t
        del p32, grads, whole, batch
        torch.cuda.empty_cache()

        # bf16 at full width, TRAIN_MESH_LAYERS layers, ZeRO-3
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        place = place_params(mesh, zero=True)
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), place=place)
        specs = placed_specs(place)
        torch.cuda.synchronize(dev)
        report["init_s"] = time.perf_counter() - t
        report["init_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        sums = {}
        map_with_path(lambda path, x: sums.__setitem__(
            path, checksum(torch, x)), params)
        report["checksums"] = sums
        report["master_bytes"] = sum(x.numel() * x.element_size()
                                     for x in lm.tree_leaves(params))
        base = adamw(schedule=schedule())
        flags = []

        def update(grads, state, p, step, axes=None):
            if step == 0:       # every leaf gathered whole, tested on rank 0
                t = time.perf_counter()
                whole = gather_tree(grads, specs, mesh, site="check.gather")
                if mesh.rank == 0:
                    names, leaves = zip(*named_leaves(whole))
                    f = torch.stack([torch.stack([torch.isfinite(g).all(),
                                                  (g != 0).any()])
                                     for g in leaves]).cpu()
                    flags.extend(zip(names, f.tolist()))
                del whole
                report["gather_s"] = time.perf_counter() - t
            return base.update(grads, state, p, step, axes=axes)
        opt = Optimizer("adamw", base.init, update)
        _mesh, axes = mesh_axes(specs)
        state = opt.init(params, axes=axes)
        step_fn = make_train_step(cfg, opt, dtype=torch.bfloat16,
                                  specs=specs)
        dry_join(twin)              # before the first timed window
        report["steps"] = []
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_at(dcfg, i).items()}
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            coll.reset_counts()
            ops.reset_launch_counts()
            t = time.perf_counter()
            params, state, loss = step_fn(params, state, batch, i)
            torch.cuda.synchronize(dev)
            report["steps"].append(dict(
                s=time.perf_counter() - t, loss=loss.item(),
                launches=ops.launch_counts(), collectives=coll.counts(),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30))
        last = report["steps"][-1]
        report["dry"] = dry_report(twin, 0, {f"step {steps - 1}": (
            last["collectives"], last["peak_gib"])})
        whole = gather_tree([leaf_at(params, k) for k in TRAIN_WITNESS],
                            [leaf_at(specs, k) for k in TRAIN_WITNESS],
                            mesh, site="check.gather")
        if mesh.rank == 0:
            torch.save([w.cpu() for w in whole], f"{out_dir}/witness.pt")
        del params, state, loss, batch, whole
    out["flags"] = flags
    out["reports"] = coll.gather_objects(report, mesh)
    return out


def k4_mesh_train_shape(torch, ops, F, dev, B, H, Hkv, S, D, seed,
                        reps=10) -> dict:
    """K4 at a mesh rank's training shape (``k4_train_check``), timed by
    the profiler's device time (at this size CUDA events around
    back-to-back calls read the host's launch cost): the forward kernel
    and the backward kernel's three launches, beside the bounds
    (``k4_bounds``), the plain version's forward + backward and
    ``k4_bwd_yardsticks``."""
    from repro_torch.kernels import flash_attention as K4

    (q, k, v, do), (o, lse), err, plain_grads = k4_train_check(
        torch, ops, dev, B, H, Hkv, S, D, seed)
    o_err, twin = err.pop("o"), err.pop("twin")
    err.pop("lse")
    grad_err = err

    fwd = device_ms(torch, lambda: K4._kernel(q, k, v, True, None,
                                              with_lse=True), reps,
                    "flash_bf16_kernel")
    bwd = device_ms(torch, lambda: ops.flash_attention_backward(
        q, k, v, o, lse, do, True), reps)
    plain = event_ms(torch, plain_grads, 2, warmup=1)
    tensor_code, lib_bwd, lib = k4_bwd_yardsticks(torch, ops, F, q, k, v, o,
                                                  lse, do)
    fwd_b, bwd_b, both_b = k4_bounds(q, k, v, o, lse, do,
                                     B * H * (S * (S + 1) // 2))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return dict(q_shape=[B, H, S, D], kv_shape=[B, Hkv, S, D], causal=True,
                fwd_ms=fwd, fwd_bound_ms=fwd_b[0], fwd_bound_by=fwd_b[1],
                bwd_ms=bwd, bwd_bound_ms=bwd_b[0], bwd_bound_by=bwd_b[1],
                fwd_bwd_ms=fwd + bwd, fwd_bwd_bound_ms=both_b[0],
                tensor_code_bwd_ms=tensor_code, plain_fwd_bwd_ms=plain,
                sdpa_bwd_ms=lib_bwd, sdpa_fwd_bwd_ms=lib,
                o_max_abs_err=o_err, **grad_err, twin=twin,
                timed_by=timed_by(fwd, bwd))


def train_mesh_phase(torch, ops, dev, train, k4_row, bwd_row) -> None:
    """``[train-mesh]``, after ``[train]`` with its weights freed:
    stablelm-1.6b at full width, its first TRAIN_MESH_LAYERS layers,
    trained over make_test_mesh(2, 4), 8 ranks sharing this card over
    gloo, ZeRO-3 (``place_params(mesh, zero=True)``), f32 masters, bf16
    compute, AdamW, ``[train]``'s batch (8 × 2,048, 4 rows a data rank);
    held to the one card's run of the same layers (``train_twin``)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.profile import TRAIN_ARCH, TRAIN_B, TRAIN_S
    from repro_torch.train import make_grad_fn

    t_phase = time.perf_counter()
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_MESH_LAYERS)
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    # the blocks' and the steps' witness: the one card's run of the same
    # layers (the seed-0 tree cut as each rank cuts it)
    twin = train_twin(torch, dev, cfg, TRAIN_MESH_STEPS)
    sums = twin["checksums"]
    # the one card's f32 answer on the same weights and batch, on the host
    grad_batch = {k: torch.from_numpy(v) for k, v in batch_at(DataConfig(
        cfg.vocab, GRAD_CHECK_S, GRAD_CHECK_B, seed=1), 0).items()}
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    loss, grads = make_grad_fn(small, dtype=torch.float32)(
        p32, {k: v.to(dev) for k, v in grad_batch.items()})
    want_loss, want = float(loss), [g.cpu() for g in grads]
    del p32, loss, grads
    torch.cuda.empty_cache()

    # K4 at the rank's training shape, alone on the card
    B, H, Hkv = TRAIN_B // MESH_DATA, cfg.n_heads // MESH_MODEL, \
        cfg.n_kv_heads // MESH_MODEL
    rec = k4_mesh_train_shape(torch, ops, F, dev, B, H, Hkv, TRAIN_S,
                              cfg.hd, 31)

    tmp = tempfile.mkdtemp(prefix="train_mesh_")
    try:
        t, wall = time.perf_counter(), time.time()
        out = run_on_ranks(train_mesh_job, make_test_mesh(MESH_DATA,
                                                          MESH_MODEL),
                           cfg, small, grad_batch, TRAIN_MESH_STEPS, tmp,
                           timeout=900)
        s_spawn = time.perf_counter() - t
        got = torch.load(f"{tmp}/grads.pt")
        witness = torch.load(f"{tmp}/witness.pt")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reports = out["reports"]
    log(f"[train-mesh] {len(reports)} ranks of make_test_mesh({MESH_DATA}, "
        f"{MESH_MODEL}) on this card over gloo in one spawn: {s_spawn:.1f} "
        f"s, of which {out['started'] - wall:.1f} s until every rank ran")
    dry_verdict("[train-mesh]", reports, "master_bytes")

    # f32 at 2 layers: the loss and every gathered gradient leaf
    check(abs(got["loss"] / want_loss - 1) <= 1e-5, f"[train-mesh] f32 "
          f"loss {got['loss']!r} against the one card's {want_loss!r}")
    check(len(got["grads"]) == len(want), "[train-mesh] gradient leaves")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got["grads"], want)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        check(a.shape == b.shape and err <= 1e-4 * scale, f"[train-mesh] "
              f"gradient leaf {i} {tuple(b.shape)}: max |d| {err:.3e} "
              f"above 1e-4 × {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    for r in reports:
        check(r["f32_launches"] == {"flash_attention": 2 * CHECK_LAYERS},
              f"[train-mesh] rank {r['coords']} f32 step launched "
              f"{r['f32_launches']}")
    log(f"[train-mesh] f32, {CHECK_LAYERS} layers at full width, "
        f"{GRAD_CHECK_B} × {GRAD_CHECK_S} tokens (1 row a data rank): loss "
        f"{got['loss']:.7f} against the one card's {want_loss:.7f} (rel "
        f"{abs(got['loss'] / want_loss - 1):.2e}, rtol 1e-5); every one of "
        f"the {len(want)} gradient leaves, gathered whole by gather_tree, "
        f"within {worst:.3e} of its largest magnitude of the one card's "
        f"(1e-4)")
    del got, want

    # the blocks are the one-card tree's
    for r in reports:
        bad = [p for p, c in r["checksums"].items()
               if c != sums[p][r["rank"]]]
        check(not bad, f"[train-mesh] rank {r['coords']}: blocks differ "
              f"from the one-card tree at {bad[:3]}")
    log(f"[train-mesh] every rank's {len(reports[0]['checksums'])} ZeRO-3 "
        f"blocks equal [train]'s seed-0 tree (its first {cfg.n_layers} "
        f"layers) cut on both axes, by checksum; "
        f"per rank {reports[0]['master_bytes'] / 1e9:.3f} GB of f32 masters, "
        f"built in {max(r['init_s'] for r in reports):.1f} s (peak "
        f"{max(r['init_peak_gib'] for r in reports):.2f} GiB)")

    # bf16: everything logged first, then the gates
    losses = [s["loss"] for s in reports[0]["steps"]]
    one = twin["losses"]
    t_step = float(np.mean([max(r["steps"][i]["s"] for r in reports)
                            for i in range(1, TRAIN_MESH_STEPS)]))
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    ceiling = flops / BF16_OPS_PER_S
    peak = max(s["peak_gib"] for r in reports for s in r["steps"])
    rel = [abs(a / b - 1) for a, b in zip(losses, one)]
    note = ("ranks share this one card over gloo (staged through host "
            "memory): these times measure that transport, not an "
            "interconnect")
    log(f"[train-mesh] bf16 {cfg.name} at full width, {cfg.n_layers} of its "
        f"{full.n_layers} layers (cut for the script's time), ZeRO-3 over "
        f"(data {MESH_DATA}, model {MESH_MODEL}), "
        f"AdamW under [train]'s cosine schedule, {TRAIN_MESH_STEPS} steps of "
        f"{TRAIN_B} × {TRAIN_S} tokens ({TRAIN_B // MESH_DATA} rows a data "
        f"rank): losses {[round(x, 6) for x in losses]} against the one "
        f"card's at the same depth {[round(x, 6) for x in one]} at the same "
        f"steps (rel "
        f"{', '.join(f'{x:.2e}' for x in rel)}; tolerance "
        f"{TRAIN_MESH_LOSS_RTOL}); steps "
        f"1–{TRAIN_MESH_STEPS - 1}: {t_step:.3f} s/step (the slowest rank) "
        f"= {tokens / t_step:.1f} tokens/s (ceiling {ceiling * 1e3:.3f} ms "
        f"= {tokens / ceiling:.1f} tokens/s; {ceiling / t_step:.2%} of it; "
        f"[train] on one card at {full.n_layers} layers "
        f"{np.mean(train['ms'][TRAIN_TIMED_FROM:]):.1f} ms/step); peak "
        f"{peak:.2f} GiB a rank; the f32 check {max(r['f32_s'] for r in reports):.1f} s, "
        f"step 0's gather of every gradient leaf "
        f"{max(r['gather_s'] for r in reports):.1f} s; K4 at ({B}, {H}/{Hkv}, "
        f"{TRAIN_S}, {cfg.hd}); {note}")
    for r in reports:
        for i, s in enumerate(r["steps"]):
            sites = {site: (round(c["seconds"], 4), c["bytes"], c["calls"])
                     for site, c in s["collectives"].items()}
            log(f"[train-mesh] rank {r['coords']} step {i}: {s['s']:.3f} s, "
                f"loss {s['loss']:.6f}, launches {json.dumps(s['launches'])},"
                f" peak {s['peak_gib']:.2f} GiB; collectives (seconds, bytes,"
                f" calls) by site {json.dumps(sites)}")
    for r in reports:
        check([s["loss"] for s in r["steps"]] == losses, f"[train-mesh] "
              f"rank {r['coords']} losses differ from rank 0's")
        for i, s in enumerate(r["steps"]):
            got = {k: v for k, v in s["launches"].items() if v}
            check(got == {"flash_attention": 2 * cfg.n_layers,
                          "flash_attention_bwd": cfg.n_layers},
                  f"[train-mesh] rank {r['coords']} step {i} launched "
                  f"{got}, not K4 {2 * cfg.n_layers} times and its backward "
                  f"{cfg.n_layers}")
    # [train]'s own losses rise at step 2 under the schedule's warmup (its
    # last-below-first holds over its 10 steps), so the mesh's are held to
    # the one card's at each step, and its parameters after the last step
    # to the one card's after the same step
    ups = []
    for keys, init, one_p, got_p in zip(TRAIN_WITNESS, twin["init"],
                                        twin["after"], witness):
        check(got_p.shape == one_p.shape, f"[train-mesh] {keys}: shape "
              f"{tuple(got_p.shape)}, not {tuple(one_p.shape)}")
        ups.append(float((got_p - one_p).norm() / (one_p - init).norm()))
    log(f"[train-mesh] after step {TRAIN_MESH_STEPS - 1}, "
        f"‖mesh − one card‖ / ‖one card − init‖ of "
        + ", ".join(f"{'/'.join(map(str, k))} {u:.4e}"
                    for k, u in zip(TRAIN_WITNESS, ups))
        + f" (tolerance {TRAIN_MESH_UPDATE_TOL})")
    check(all(np.isfinite(losses)) and max(rel) <= TRAIN_MESH_LOSS_RTOL,
          f"[train-mesh] losses {losses} against the one card's {one}: not "
          f"finite or beyond {TRAIN_MESH_LOSS_RTOL}")
    check(all(u <= TRAIN_MESH_UPDATE_TOL for u in ups), f"[train-mesh] "
          f"parameters after step {TRAIN_MESH_STEPS - 1}: {ups} of "
          f"the one card's update, beyond {TRAIN_MESH_UPDATE_TOL}")
    bad = [n for n, (finite, nonzero) in out["flags"]
           if not (finite and nonzero)]
    check(len(out["flags"]) == len(reports[0]["checksums"]) and not bad,
          f"[train-mesh] step 0: {len(out['flags'])} gradient leaves, not "
          f"finite or all zero: {bad[:5]}")
    log(f"[train-mesh] every one of the {len(out['flags'])} gradient leaves "
        f"gathered whole at step 0 finite and non-zero; K4 "
        f"{2 * cfg.n_layers} launches a rank a step, its backward kernel "
        f"{cfg.n_layers}")
    launches = sum(sum(s["launches"].get("flash_attention", 0)
                       for s in r["steps"]) for r in reports)
    bwd_launches = sum(sum(s["launches"].get("flash_attention_bwd", 0)
                           for s in r["steps"]) for r in reports)
    k4_row["launches"] += launches
    k4_row["train_mesh_shape"] = dict(rec, launches=launches)
    bwd_row["launches"] += bwd_launches
    bwd_row["train_mesh_shape"] = dict(rec, launches=bwd_launches)
    log(f"[K4] the training rank's shape q {tuple(rec['q_shape'])} k/v "
        f"{tuple(rec['kv_shape'])} causal, bf16, profiler device time: "
        f"forward with LSE {rec['fwd_ms']:.4f} ms (bound "
        f"{rec['fwd_bound_ms']:.4f}, {rec['fwd_bound_by']}, "
        f"{rec['fwd_bound_ms'] / rec['fwd_ms']:.1%}; o max |d| "
        f"{rec['o_max_abs_err']:.3e}); {launches} launches on the ranks' "
        f"path, the backward kernel's {bwd_launches}")
    k4_bwd_log("[K4] the training rank's shape:", rec)
    log(f"[train-mesh] phase {time.perf_counter() - t_phase:.1f} s")


def in_turns(torch, mesh, draw, drawing: bool = True):
    """``draw()`` on one rank at a time (the ranks with ``drawing``), each
    emptying its cache after: ``init_params(place=)`` draws every part
    whole before a rank keeps its blocks, and eight ranks drawing
    llama4-scout's 8 GB f32 expert banks at once would not fit on the
    card."""
    from repro_torch.dist import collectives as coll
    out = None
    for turn in range(mesh.size):
        if turn == mesh.rank and drawing:
            out = draw()
            torch.cuda.synchronize(mesh.device)
            torch.cuda.empty_cache()
        coll.pmax(torch.zeros(1), mesh, site="init.turn")
    return out


def moe_mesh_job(mesh, cfg, f32_cfg, tokens, f32_tokens, prompt,
                 new_tokens):
    """``[moe-mesh]`` on one rank of make_test_mesh(2, 4): llama4-scout's
    experts split over "model".  The f32 check (prefill logits and
    MESH_F32_STEPS decode steps, gathered whole), then bf16 from the card
    generator's seed-0 draws: the checksums of this rank's blocks, a
    warm-up and a timed prefill (K4 counted; the routing of its rows
    recorded), then ``generate``.  Rank 0 returns the gathered values;
    every rank's report comes through ``gather_objects``."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import (SINGLE_POD_RULES, active_spec,
                                           shard, unshard, use_rules)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models import moe as M
    from repro_torch.train import (make_decode_fn, make_prefill_step,
                                   place_params)
    from repro_torch.train.shardings import map_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    out = {"started": float(coll.pmax(torch.tensor(
        [time.time()], dtype=torch.float64), mesh))}
    report = {"coords": mesh.coords}
    mo = cfg.moe
    twin = dry_start([serving_twin(torch, mesh, cfg, {"tokens": tokens},
                                   prompt, new_tokens)])
    with use_rules(SINGLE_POD_RULES, mesh):
        report["experts_split"] = lm.tensor_parallel(cfg).experts
        p32 = in_turns(torch, mesh, lambda: lm.init_params(
            f32_cfg, torch.Generator(device=dev).manual_seed(1),
            place=place_params(mesh)))
        toks = f32_tokens.to(dev)
        routing = []
        with spy((M, "moe_apply", routing_recorder(
                torch, M, mo, M.expert_capacity(
                    toks.shape[1], mo.top_k, mo.n_experts,
                    mo.capacity_factor), routing))):
            out["f32_logits"] = make_prefill_step(
                f32_cfg, dtype=torch.float32)(p32, {"tokens": toks})
        report["f32_routing"] = [(k, n) for k, n, _load in routing]
        B = toks.shape[0]
        spec = active_spec((B,), "batch")
        cache = lm.init_cache(f32_cfg, B, MESH_F32_STEPS,
                              dtype=torch.float32, device=dev)
        step = make_decode_fn(f32_cfg, dtype=torch.float32,
                              max_len=MESH_F32_STEPS)
        tp = lm.tensor_parallel(f32_cfg)
        mine = shard(toks, "batch", None)
        steps = []
        for t in range(MESH_F32_STEPS):
            logits, cache = step(p32, cache, mine[:, t:t + 1], t)
            (logits,) = lm.L.gather_cols([logits], tp.axis(tp.vocab),
                                         site="check")
            steps.append(unshard(logits, spec + (None, None), mesh))
        out["f32_steps"] = torch.cat(steps, 1)
        del p32, cache, logits, steps
        torch.cuda.empty_cache()

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        params = in_turns(torch, mesh, lambda: lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0),
            dtype=torch.bfloat16, place=place_params(mesh)))
        torch.cuda.synchronize(dev)
        report["init_s"] = time.perf_counter() - t
        report["init_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        sums = {}
        map_with_path(lambda path, x: sums.__setitem__(
            path, checksum(torch, x)), params)
        report["checksums"] = sums
        report["weight_bytes"] = sum(x.numel() * x.element_size()
                                     for x in lm.tree_leaves(params))
        toks = tokens.to(dev)
        capacity = M.expert_capacity(toks.shape[1], mo.top_k, mo.n_experts,
                                     mo.capacity_factor)
        prefill_step = make_prefill_step(cfg, dtype=torch.bfloat16)
        dry_join(twin)              # before the first timed window
        prefill_step(params, {"tokens": toks})            # warm-up
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        coll.reset_counts()
        ops.reset_launch_counts()
        routing = []
        with spy((M, "moe_apply", routing_recorder(torch, M, mo, capacity,
                                                  routing))):
            t = time.perf_counter()
            logits = prefill_step(params, {"tokens": toks})
            torch.cuda.synchronize(dev)
            report["prefill_s"] = time.perf_counter() - t
        report["prefill_launches"] = ops.launch_counts()
        report["prefill_collectives"] = coll.counts()
        report["prefill_peak_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
        report["routing"] = [(k, n) for k, n, _load in routing]
        out["logits"] = logits

        prompt = prompt.to(dev)
        generate(params, cfg, prompt[:, :2], 2, dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats(dev)
        coll.reset_counts()
        ops.reset_launch_counts()
        served = generate(params, cfg, prompt, new_tokens,
                          dtype=torch.bfloat16)
        report["decode_s"] = served.seconds
        report["decode_launches"] = ops.launch_counts()
        report["decode_collectives"] = coll.counts()
        report["decode_peak_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
        out["served"] = served
        report["dry"] = dry_report(twin, 0, {
            "prefill": (report["prefill_collectives"],
                        report["prefill_peak_gib"]),
            "decode": (report["decode_collectives"],
                       report["decode_peak_gib"])})
    out["reports"] = coll.gather_objects(report, mesh)
    return out


def moe_mesh_phase(torch, ops, dev, k4_row) -> None:
    """``[moe-mesh]``, after ``[moe]`` with its weights freed:
    llama4-scout at published width, MOE_MESH_LAYERS of its 48 layers,
    served over make_test_mesh(2, 4) with its 16 experts 4 a model rank
    (expert parallelism), 8 ranks sharing this card over gloo."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_cache, init_params
    from repro_torch.models import moe as M
    from repro_torch.train import make_decode_fn, make_prefill_step

    t_phase = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_MESH_LAYERS)
    small = dataclasses.replace(full, n_layers=MOE_MESH_F32_LAYERS)
    mo = cfg.moe
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (PREFILL_B, PREFILL_S)))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (SERVE_B, MOE_MESH_PROMPT)))
    f32_tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                               (SERVE_B, SERVE_PROMPT)))

    # the one card's f32 answer (seed-1 draws, 1 layer)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    toks = f32_tokens.to(dev)
    routing = []
    with spy((M, "moe_apply", routing_recorder(torch, M, mo, M.expert_capacity(
            SERVE_PROMPT, mo.top_k, mo.n_experts, mo.capacity_factor),
            routing))):
        want_logits = make_prefill_step(small, dtype=torch.float32)(
            p32, {"tokens": toks}).cpu()
    one_f32_routing = [(k, n) for k, n, _load in routing]
    cache = init_cache(small, SERVE_B, MESH_F32_STEPS, dtype=torch.float32,
                       device=dev)
    step = make_decode_fn(small, dtype=torch.float32)
    want_steps = []
    for t in range(MESH_F32_STEPS):
        logits, cache = step(p32, cache, toks[:, t:t + 1], t)
        want_steps.append(logits.cpu())
    want_steps = torch.cat(want_steps, 1)
    del p32, cache, logits
    torch.cuda.empty_cache()

    # the one card's bf16 witness on the same weights (seed 0, the first
    # MOE_MESH_LAYERS layers of [moe]'s draws)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    sums = mesh_checksums(torch, params)
    capacity = M.expert_capacity(PREFILL_S, mo.top_k, mo.n_experts,
                                 mo.capacity_factor)
    routing = []
    with spy((M, "moe_apply", routing_recorder(torch, M, mo, capacity,
                                              routing))):
        one_logits = make_prefill_step(cfg, dtype=torch.bfloat16)(
            params, {"tokens": tokens.to(dev)}).float().cpu()
    one_routing = [(k, n) for k, n, _load in routing]
    one_served = generate(params, cfg, prompt.to(dev), MOE_MESH_TOKENS,
                          dtype=torch.bfloat16)
    del params, routing
    gc.collect()
    torch.cuda.empty_cache()

    # K4 at the rank's shape, alone on the card, before the ranks start
    gen = torch.Generator(device=dev).manual_seed(6)
    B, Hq, Hkv = PREFILL_B // MESH_DATA, cfg.n_heads // MESH_MODEL, \
        cfg.n_kv_heads // MESH_MODEL
    q = torch.randn(B, Hq, PREFILL_S, cfg.hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(B, Hkv, PREFILL_S, cfg.hd, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    err, _err_r, _ms, plain, _lib, _got = k4_yardstick(torch, ops, F, q, k,
                                                       v, True)
    times = k4_rank_times(torch, ops, F, q, k, v)

    t, wall = time.perf_counter(), time.time()
    out = run_on_ranks(moe_mesh_job, make_test_mesh(MESH_DATA, MESH_MODEL),
                       cfg, small, tokens, f32_tokens, prompt,
                       MOE_MESH_TOKENS, timeout=600)
    s_spawn = time.perf_counter() - t
    reports = out["reports"]
    log(f"[moe-mesh] {len(reports)} ranks of make_test_mesh({MESH_DATA}, "
        f"{MESH_MODEL}) on this card over gloo in one spawn: {s_spawn:.1f} "
        f"s, of which {out['started'] - wall:.1f} s until every rank ran; "
        f"{cfg.name} cut to {MOE_MESH_LAYERS} of {full.n_layers} layers "
        f"(each data rank holds a whole copy of its model block: 12 layers "
        f"would need ≈ 114 GB over the ranks)")
    dry_verdict("[moe-mesh]", reports)

    def rel(got, want):
        return float((got.float().cpu() - want.float().cpu()).abs().max()
                     / want.float().abs().max())

    check(all(r["experts_split"] for r in reports), "[moe-mesh] the expert "
          "banks are not split over the model axis")

    def routed(key):            # each data rank routes its rows
        rows = [r[key] for r in reports if r["coords"]["model"] == 0]
        return [(sum(x[i][0] for x in rows), sum(x[i][1] for x in rows))
                for i in range(len(rows[0]))]
    f32_routing = routed("f32_routing")
    check(f32_routing == one_f32_routing, f"[moe-mesh] f32: kept/routed "
          f"pairs {f32_routing} on the mesh, {one_f32_routing} on the one "
          "card")
    e_pre = rel(out["f32_logits"], want_logits)
    e_dec = rel(out["f32_steps"], want_steps)
    check(e_pre <= 1e-4 and e_dec <= 1e-4, f"[moe-mesh] f32: the mesh's "
          f"logits are {e_pre:.3e} (prefill) and {e_dec:.3e} (decode) of "
          "the largest from the one card's")
    log(f"[moe-mesh] f32, {MOE_MESH_F32_LAYERS} layer at published width, "
        f"{mo.n_experts // MESH_MODEL} experts a model rank, B={SERVE_B}: "
        f"prefill logits {e_pre:.3e} and {MESH_F32_STEPS} decode steps' "
        f"logits {e_dec:.3e} of the largest |logit| from the one card's on "
        f"the same weights (tolerance 1e-4); kept/routed pairs "
        f"{f32_routing}, the one card's exactly")
    for r in reports:
        m = r["coords"]["model"]
        bad = [p for p, c in r["checksums"].items() if c != sums[p][m]]
        check(not bad, f"[moe-mesh] rank {r['coords']}: blocks differ from "
              f"the one-card tree at {bad[:3]}")
    log(f"[moe-mesh] every rank's {len(reports[0]['checksums'])} blocks "
        f"equal the one-card tree's by checksum; per rank "
        f"{reports[0]['weight_bytes'] / 1e9:.3f} GB of bf16 weights, built "
        f"in {max(r['init_s'] for r in reports):.1f} s, one rank at a time "
        f"(peak {max(r['init_peak_gib'] for r in reports):.2f} GiB)")

    for r in reports:
        got = {k: v for k, v in r["prefill_launches"].items() if v}
        check(got == {"flash_attention": MOE_MESH_LAYERS}, f"[moe-mesh] "
              f"rank {r['coords']} prefill launched {got}, not K4 "
              f"{MOE_MESH_LAYERS} times")
        check(not any(r["decode_launches"].values()), f"[moe-mesh] rank "
              f"{r['coords']} decode launched {r['decode_launches']}")
    logits, served = out["logits"], out["served"]
    check(logits.shape == (PREFILL_B, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "[moe-mesh] prefill "
          "logits")
    e_bf16 = rel(logits, one_logits)
    check(e_bf16 <= 2e-2, f"[moe-mesh] bf16 prefill logits {e_bf16:.3e} of "
          "the largest from the one card's")
    mesh_routing = routed("routing")
    for r in reports:
        m0 = next(x for x in reports if x["coords"]["model"] == 0
                  and x["coords"]["data"] == r["coords"]["data"])
        check(r["routing"] == m0["routing"], f"[moe-mesh] rank "
              f"{r['coords']} routed its rows unlike its model line")

    def share(rt):
        return [1 - k / n for k, n in rt]

    def total(rt):
        return 1 - sum(k for k, _ in rt) / sum(n for _, n in rt)
    log(f"[moe-mesh] bf16 routing at capacity {capacity} slots an expert a "
        f"group of {PREFILL_S}: kept/routed pairs by layer on the mesh "
        f"{mesh_routing}, on the one card {one_routing}; dropped shares "
        f"{[round(x, 6) for x in share(mesh_routing)]} against "
        f"{[round(x, 6) for x in share(one_routing)]} (each layer's kept "
        f"pairs held within {MOE_MESH_DROP_SLACK} of its routed pairs); "
        f"over the {MOE_MESH_LAYERS} layers {total(mesh_routing):.6f} "
        f"against {total(one_routing):.6f}")
    check([n for _, n in mesh_routing] == [n for _, n in one_routing]
          and all(abs(a - b) <= MOE_MESH_DROP_SLACK * n for (a, n), (b, _n)
                  in zip(mesh_routing, one_routing)), f"[moe-mesh] bf16 "
          f"kept/routed pairs by layer {mesh_routing} against the one "
          f"card's {one_routing}: a layer beyond {MOE_MESH_DROP_SLACK} of "
          f"its routed pairs")
    check(served.finite and served.tokens.shape == (SERVE_B, MOE_MESH_TOKENS)
          and int(served.tokens.max()) < cfg.vocab, "[moe-mesh] decode "
          "output")
    agree = int((served.tokens.cpu() == one_served.tokens.cpu()).sum())
    t_pre = max(r["prefill_s"] for r in reports)
    ms_step = max(r["decode_s"] for r in reports) * 1e3 / served.steps
    launches = sum(r["prefill_launches"]["flash_attention"] for r in reports)
    note = ("ranks share this one card over gloo (staged through host "
            "memory): these times measure that transport, not an "
            "interconnect")
    log(f"[moe-mesh] bf16 {cfg.name}, {MOE_MESH_LAYERS} layers at published "
        f"width: prefill {PREFILL_B} x {PREFILL_S} ({PREFILL_B // MESH_DATA}"
        f" rows a data rank) {t_pre * 1e3:.1f} ms = "
        f"{PREFILL_B * PREFILL_S / t_pre:.1f} tokens/s (the slowest rank); "
        f"logits {e_bf16:.3e} of the largest |logit| from the one card's "
        f"prefill on the same weights (tolerance 2e-2); K4 "
        f"{MOE_MESH_LAYERS} launches a rank at ({B}, {Hq}/{Hkv}, "
        f"{PREFILL_S}, {cfg.hd}), {launches} in all; decode B={SERVE_B}, "
        f"prompt {MOE_MESH_PROMPT} + {MOE_MESH_TOKENS} greedy tokens: "
        f"{ms_step:.3f} ms/token-step (the slowest rank), every logit "
        f"finite; {agree} of {served.tokens.numel()} greedy tokens equal "
        f"the one card's (not gated); {note}")
    for r in reports:
        sites = {phase: {site: (round(c["seconds"], 4), c["bytes"],
                                c["calls"])
                         for site, c in r[f"{phase}_collectives"].items()}
                 for phase in ("prefill", "decode")}
        log(f"[moe-mesh] rank {r['coords']}: prefill {r['prefill_s']:.3f} "
            f"s, decode {r['decode_s']:.3f} s, peak "
            f"{r['prefill_peak_gib']:.2f} / {r['decode_peak_gib']:.2f} GiB; "
            f"collectives (seconds, bytes, calls) by site "
            f"{json.dumps(sites)}")

    pairs = PREFILL_S * (PREFILL_S + 1) // 2
    flops = 4 * cfg.hd * pairs * B * Hq
    bms, by = bound_ms(2 * (2 * q.numel() + 2 * k.numel()), flops,
                       BF16_OPS_PER_S)
    ms, lib = times["k4_device"], times["sdpa_device"]
    k4_row["launches"] += launches
    k4_row["moe_mesh_shape"] = dict(shape=[B, Hq, Hkv, PREFILL_S, cfg.hd],
                                    launches=launches, max_abs_err=err,
                                    ms=ms, plain_ms=plain, bound_ms=bms,
                                    bound_by=by, library_ms=lib,
                                    timed_by=timed_by(ms, lib))
    log(f"[K4] the MoE rank's shape q {tuple(q.shape)} k/v {tuple(k.shape)}"
        f": max |d| {err:.3e}; device time {ms:.4f} ms/launch = "
        f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of it; plain {plain:.3f} ms; "
        f"scaled_dot_product_attention device time {lib:.4f} ms; {times}")
    del q, k, v
    torch.cuda.empty_cache()
    log(f"[moe-mesh] phase {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------------
# [family-mesh]: MLA, SSD, the hybrid and the encoder–decoder served over the
# (data, model) mesh as ranks on one card

# deepseek-v3: 1 dense + 1 MoE layer of its 61 (first_k_dense 1, all 256
# experts, 64 a model rank: ≈ 27.8 GB a copy, one a data line).  jamba:
# one 8-sublayer period with 4 of its 16 experts, one a model rank (≈ 32.2
# GB), on make_test_mesh(1, 4): two copies (≈ 64.4 GB) beside eight ranks'
# prefill activations pass the card's 80 GB.  mamba2-130m and
# seamless-m4t-large-v2 whole.  The f32 checks at 1 layer (deepseek: its
# dense MLA layer), 2 (mamba2), 1 + 1 (seamless), and jamba's period cut to
# 2 sublayers (SSD with the dense FFN, attention with the 4-expert MoE:
# ≈ 18.6 GB; the 8-sublayer period is ≈ 64.6 GB in f32)
FM_MLA_LAYERS = 2
FM_HYB_EXPERTS = 4
FM_F32_S, FM_F32_SRC = 128, 64       # the f32 prompt (a chunk), frames
FM_WARM_S = 256                      # the warm-up prefill's positions
FM_PROMPT, FM_TOKENS = 2, 2          # the decode: prompt, greedy tokens
# random-weight SSD stacks amplify bf16 rounding chaotically, in the JAX
# package as in the port (tests/test_torch_ssd_bf16_noise.py: mamba2-130m's
# bf16 prefill on the CPU is 1.2e-2 / 3.6e-2 / 5.4e-2 / 0.637 of the
# largest logit from its f32 twin at 1 / 2 / 4 / 24 layers in the
# reference, 1.0e-2 / 1.9e-2 / 3.0e-2 / 0.713 in the port); on an H100
# 80GB HBM3 at 700 W (scripts/ssd_bf16_noise.py) the one card reads
# 8.1e-3–9.6e-3 (1 layer), 1.5e-2–2.8e-2 (2), 3.2e-2–4.3e-2 (4) and 0.945
# (24), the mesh 0.95–1.23 times as far, the mesh to the one card
# 6.7e-3–6.9e-3 at 1 layer, 1.0e-2 at 2 and 2.5e-2–3.6e-2 at 4.  So every
# model's bf16 is held to the one card's at one layer (its f32 check's
# first layer or period, the seed-1 weights in bf16) within 2e-2, the
# attention stacks at the phase's depth within 2e-2 too, and mamba2's
# first FM_SSD_DEPTH layers (the seed-0 tree's) to their f32 twin within
# FM_SSD_TWIN_TOL, the mesh and the one card alike (the band the test
# holds the reference and the port to at that depth; the mesh read
# 4.65e-2 there, 1.49 times the one card's 3.12e-2); a whole SSD stack's
# bf16 (mamba2's 24 layers, jamba's period of 7 SSD sublayers) is logged
FM_SSD_STACKS = ("mamba2", "jamba")
FM_SSD_DEPTH, FM_SSD_TWIN_TOL = {"mamba2": 4}, 0.1
# the collective sites each family's prefill and decode must call
FM_SITES = {
    "deepseek": ({"attn.o", "ffn.down", "moe.combine"},
                 {"decode.qkv", "decode.merge", "attn.o", "moe.combine"}),
    "mamba2": ({"ssd.norm", "ssd.out"}, {"decode.ssd", "ssd.out"}),
    "seamless": ({"attn.o", "xattn.o", "ffn.down"},
                 {"decode.qkv", "decode.merge", "xattn.o", "ffn.down"}),
    "jamba": ({"ssd.norm", "ssd.out", "attn.o", "ffn.down", "moe.combine"},
              {"decode.ssd", "ssd.out", "decode.qkv", "decode.merge",
               "moe.combine"}),
}


def family_mesh_models(get_config) -> list:
    """(tag, bf16 config, f32 config, mesh (data, model)) of each model
    ``[family-mesh]`` serves, in its order."""
    import dataclasses
    ds, mb, sm, jb = (get_config(a) for a in (
        "deepseek_v3_671b", "mamba2_130m", "seamless_m4t_large_v2",
        "jamba_1_5_large_398b"))
    ds_moe = dataclasses.replace(ds.moe, first_k_dense=1)
    jb_moe = dataclasses.replace(jb.moe, n_experts=FM_HYB_EXPERTS)
    line = (MESH_DATA, MESH_MODEL)
    return [
        ("deepseek", dataclasses.replace(ds, n_layers=FM_MLA_LAYERS,
                                         moe=ds_moe),
         dataclasses.replace(ds, n_layers=1, moe=ds_moe), line),
        ("mamba2", mb, dataclasses.replace(mb, n_layers=CHECK_LAYERS), line),
        ("seamless", sm, dataclasses.replace(sm, n_layers=1,
                                             n_encoder_layers=1), line),
        ("jamba", dataclasses.replace(jb, n_layers=jb.attn_period,
                                      moe=jb_moe),
         dataclasses.replace(jb, n_layers=2, attn_period=2, attn_index=1,
                             moe=jb_moe), (1, MESH_MODEL)),
    ]


def family_batches(torch, np, cfg, rng) -> tuple:
    """(the prefill batch, the f32 check's batch, the decode's prompt) of
    ``cfg``, CPU tensors from ``rng``: the prefill at [serve]'s 4 × 2,048
    (an encoder–decoder's at [encdec]'s 1,024 frames + 1,024 tokens)."""
    enc = cfg.family == "encdec"

    def tokens(b, s):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))

    def frames(b, s):
        return torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32))
    batch = {"tokens": tokens(PREFILL_B, ENCDEC_S if enc else PREFILL_S)}
    f32 = {"tokens": tokens(SERVE_B, FM_F32_S)}
    if enc:
        batch["src_embeds"] = frames(PREFILL_B, ENCDEC_SRC)
        f32["src_embeds"] = frames(SERVE_B, FM_F32_SRC)
    return batch, f32, tokens(SERVE_B, FM_PROMPT)


def tree_like(tree, fn):
    """``fn`` of every leaf of a tree of dicts and lists, in its shape."""
    if isinstance(tree, dict):
        return {k: tree_like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_like(v, fn) for v in tree]
    return fn(tree)


def drawn_over_data(torch, mesh, draw):
    """``draw()`` on the first data line only, one rank at a time
    (``in_turns``); each rank of the other line takes its model peer's
    blocks (the lines hold the same ones) over "data", leaf by leaf
    (``broadcast``): a rank drawing deepseek-v3's 22.6 GB MoE layer whole
    in its turn beside seven ranks' blocks would need ≈ 78 GB."""
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.mesh import as_axis
    first = mesh.coords["data"] == 0
    tree = in_turns(torch, mesh, draw, drawing=first)
    if mesh.shape["data"] == 1:
        return tree
    data = as_axis(mesh, "data")
    like = coll.broadcast_objects(None if not first else tree_like(
        tree, lambda x: (tuple(x.shape), str(x.dtype))), data)
    if not first:
        tree = tree_like(like, lambda sd: torch.empty(
            sd[0], dtype=getattr(torch, sd[1].split(".")[-1]),
            device=mesh.device))
    tree = tree_like(tree, lambda x: coll.broadcast(x, data,
                                                    site="init.copy"))
    torch.cuda.synchronize(mesh.device)
    return tree


def family_mesh_job(mesh, models):
    """``[family-mesh]`` on one rank of make_test_mesh(2, 4) (SPMD): each
    model in turn (``family_model``) on the whole mesh, or, where its
    mesh is (1, 4), on the first data line (``line_mesh``) while the
    other line's ranks wait.  Rank 0 returns the gathered values;
    every rank's reports come through ``gather_objects``."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.mesh import line_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"started": float(coll.pmax(torch.tensor(
        [time.time()], dtype=torch.float64), mesh))}
    line = line_mesh(mesh, "model", 0)

    def twin_of(on, model):     # the encoder's output: bf16 of the frames
        _tag, cfg, _small, batch, _f32, prompt, _dims = model
        memory = None if cfg.family != "encdec" else \
            batch["src_embeds"].to(torch.bfloat16)
        return serving_twin(torch, on, cfg, batch, prompt, FM_TOKENS, memory)
    ons = [(mesh if model[-1] == tuple(mesh.shape.values()) else line, model)
           for model in models]
    ons = [(on, model) for on, model in ons if on is not None]
    twin = dry_start([twin_of(on, model) for on, model in ons])
    reports = [family_model(on, model, out, twin, i)
               for i, (on, model) in enumerate(ons)]
    out["reports"] = coll.gather_objects(reports, mesh)
    return out


def family_model(mesh, model, out, twin, i):
    """One model of ``[family-mesh]`` on ``mesh`` under
    ``SINGLE_POD_RULES``: its plan; the f32 check (seed-1 draws of its f32
    config: the prefill logits and MESH_F32_STEPS decode steps, gathered
    whole, and the bf16 prefill logits of the same weights' first layer);
    then bf16 from the card generator's seed-0 draws (every draw of the
    one-card tree replayed, this rank's blocks kept), a warm-up prefill
    of FM_WARM_S positions and a timed one (K4 and the collectives
    counted), an SSD stack's first FM_SSD_DEPTH layers' prefill, a
    warm-up decode step and a timed ``generate`` (an
    encoder–decoder's steps attending the encoder's output of the
    prefill's frames); then its weights freed; the timed windows held to
    the dry twin ``twin``'s ``i``-th (``dry_start``).  The gathered
    values go into ``out``; returns this rank's report."""
    import torch
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import SINGLE_POD_RULES, use_rules
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.train import (make_decode_fn, make_prefill_step,
                                   place_params)
    from repro_torch.train.step import batch_rows, gather_rows
    dev = mesh.device
    tag, cfg, small, batch, f32_batch, prompt, _dims = model

    def to(batch):
        return {k: v.to(dev) for k, v in batch.items()}

    def counted(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        coll.reset_counts()
        ops.reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, dict(s=time.perf_counter() - t,
                         launches=ops.launch_counts(),
                         collectives=coll.counts(),
                         peak_gib=torch.cuda.max_memory_allocated(dev)
                         / 2**30)

    t_model = time.perf_counter()
    enc = cfg.family == "encdec"
    report = {"coords": mesh.coords, "tag": tag}
    with use_rules(SINGLE_POD_RULES, mesh):
        tp = lm.tensor_parallel(cfg)
        report["plan"] = {k: getattr(tp, k) for k in (
            "hp", "heads", "kv", "kv_gather", "rows", "ffn", "vocab",
            "experts", "ssd")}
        # f32 at the check's depth: the mesh against the one card
        p32 = drawn_over_data(torch, mesh, lambda: lm.init_params(
            small, torch.Generator(device=dev).manual_seed(1),
            place=place_params(mesh)))
        fb = to(f32_batch)
        out[tag, "f32_logits"] = make_prefill_step(
            small, dtype=torch.float32)(p32, fb).cpu()
        rows, spec = batch_rows(fb)
        mem = (lm.encode(p32, rows["src_embeds"], small,
                         dtype=torch.float32) if enc else None)
        cache = lm.init_cache(small, SERVE_B, MESH_F32_STEPS,
                              dtype=torch.float32, device=dev)
        step = make_decode_fn(small, dtype=torch.float32,
                              max_len=MESH_F32_STEPS)
        tp32 = lm.tensor_parallel(small)
        steps = []
        for t in range(MESH_F32_STEPS):
            logits, cache = step(p32, cache, rows["tokens"][:, t:t + 1],
                                 t, mem)
            (logits,) = lm.L.gather_cols([logits], tp32.axis(
                tp32.vocab), site="check")
            steps.append(gather_rows(logits, spec).cpu())
        out[tag, "f32_steps"] = torch.cat(steps, 1)
        out[tag, "check_logits"] = first_layer_bf16(torch, lm, small,
                                                    p32, fb)
        del p32, cache, logits, mem, rows
        gc.collect()
        torch.cuda.empty_cache()

        # bf16 at the phase's depth
        torch.cuda.synchronize(dev)
        report["free_gib"] = torch.cuda.mem_get_info(dev)[0] / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        params = drawn_over_data(torch, mesh, lambda: lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0),
            dtype=torch.bfloat16, place=place_params(mesh)))
        report["init_s"] = time.perf_counter() - t
        report["init_peak_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2**30
        report["weight_bytes"] = sum(x.numel() * x.element_size()
                                     for x in lm.tree_leaves(params))
        prefill_step = make_prefill_step(cfg, dtype=torch.bfloat16)
        b = to(batch)
        dry_join(twin)              # before the first timed window
        prefill_step(params, {k: v[:, :FM_WARM_S] for k, v in b.items()})
        logits, report["prefill"] = counted(
            lambda: prefill_step(params, b))
        out[tag, "logits"] = logits.float().cpu()
        if tag in FM_SSD_DEPTH:   # the first layers, held to their f32 twin
            cut, p = first_layers(lm, cfg, params, FM_SSD_DEPTH[tag])
            out[tag, "depth_logits"] = make_prefill_step(
                cut, dtype=torch.bfloat16)(p, b).float().cpu()
            del p
        memory = None
        if enc:                   # the encoder's output of the frames
            rows, spec = batch_rows(b)
            memory = gather_rows(lm.encode(
                params, rows["src_embeds"], cfg, dtype=torch.bfloat16),
                spec)
            del rows
        p = prompt.to(dev)
        generate(params, cfg, p[:, :1], 1, dtype=torch.bfloat16,
                 memory=memory)
        served, report["decode"] = counted(lambda: generate(
            params, cfg, p, FM_TOKENS, dtype=torch.bfloat16,
            memory=memory))
        out[tag, "served"] = served._replace(
            tokens=served.tokens.cpu(),
            prompt_logits=served.prompt_logits.float().cpu())
        report["dry"] = dry_report(twin, i, {
            "prefill": (report["prefill"]["collectives"],
                        report["prefill"]["peak_gib"]),
            "decode": (report["decode"]["collectives"],
                       report["decode"]["peak_gib"])})
        del params, memory, logits, b, served
        gc.collect()
        torch.cuda.empty_cache()
    report["model_s"] = time.perf_counter() - t_model
    return report


def first_layers(lm, cfg, params, n=None) -> tuple:
    """``cfg`` and ``params`` cut to their first ``n`` layers (by default
    the first layer: a hybrid's first period, an encoder–decoder's first
    encoder and decoder layers; a model's layers are drawn in order, so
    the cut tree is the first layers' draws)."""
    import dataclasses
    one = dataclasses.replace(cfg, n_layers=min(n or cfg.attn_period or 1,
                                                cfg.n_layers),
                              n_encoder_layers=min(cfg.n_encoder_layers, 1))
    counts = dict(lm.layer_groups(one))
    return one, {k: v[:counts[k[2:]]] if k.startswith("g_") else v
                 for k, v in params.items()}


def first_layer_bf16(torch, lm, cfg, params, batch):
    """The bf16 prefill logits (on the host) of ``params``' first layer
    (``first_layers``) cast to bf16 (``as_bf16``), on ``batch``; the cut
    tree and its cast live only here."""
    from repro_torch.train import make_prefill_step
    one, p1 = first_layers(lm, cfg, params)
    return make_prefill_step(one, dtype=torch.bfloat16)(
        as_bf16(torch, p1), batch).float().cpu()


def as_bf16(torch, tree):
    """``tree`` with its matrices in bf16 and its vectors (norm scales,
    biases, SSD's per-head leaves) as they are, as ``init_params(...,
    dtype=torch.bfloat16)`` keeps them; block by block on a rank, the
    same bits as the whole tree's."""
    return tree_like(tree, lambda t: t.to(torch.bfloat16) if t.dim() >= 2
                     else t)


def family_one_card(torch, dev, cfg, small, batch, f32_batch, prompt,
                    depth=None) -> dict:
    """The one card's answers ``[family-mesh]`` holds the mesh to, on the
    same draws: f32 (seed 1, ``small``) prefill logits on ``f32_batch`` and
    MESH_F32_STEPS decode steps' logits, and the bf16 prefill logits of
    the same weights' first layer (``first_layers``); bf16 (seed 0,
    ``cfg``) prefill logits on ``batch``, where ``depth`` is given those
    of its first ``depth`` layers and of their f32 twin, and the greedy
    tokens after ``prompt``."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import encode, init_cache, init_params, lm
    from repro_torch.models import tree_leaves
    from repro_torch.train import make_decode_fn, make_prefill_step

    def to(b):
        return {k: v.to(dev) for k, v in b.items()}
    enc = cfg.family == "encdec"
    out = {}
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    fb = to(f32_batch)
    out["f32_logits"] = make_prefill_step(small, dtype=torch.float32)(
        p32, fb).cpu()
    mem = encode(p32, fb["src_embeds"], small, dtype=torch.float32) \
        if enc else None
    cache = init_cache(small, SERVE_B, MESH_F32_STEPS, dtype=torch.float32,
                       device=dev)
    step = make_decode_fn(small, dtype=torch.float32)
    steps = []
    for t in range(MESH_F32_STEPS):
        logits, cache = step(p32, cache, fb["tokens"][:, t:t + 1], t, mem)
        steps.append(logits.cpu())
    out["f32_steps"] = torch.cat(steps, 1)
    out["check_logits"] = first_layer_bf16(torch, lm, small, p32, fb)
    del p32, cache, mem, logits
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    out["weight_bytes"] = sum(x.numel() * x.element_size()
                              for x in tree_leaves(params))
    b = to(batch)
    out["logits"] = make_prefill_step(cfg, dtype=torch.bfloat16)(
        params, b).float().cpu()
    if depth:                 # the first layers and their f32 twin
        cut, p = first_layers(lm, cfg, params, depth)
        out["depth_logits"] = make_prefill_step(cut, dtype=torch.bfloat16)(
            p, b).float().cpu()
        out["depth_twin"] = make_prefill_step(cut, dtype=torch.float32)(
            tree_like(p, lambda t: t.float()), b).cpu()
        del p
    memory = encode(params, b["src_embeds"], cfg, dtype=torch.bfloat16) \
        if enc else None
    out["tokens"] = generate(params, cfg, prompt.to(dev), FM_TOKENS,
                             dtype=torch.bfloat16,
                             memory=memory).tokens.cpu()
    del params, memory, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_k4(torch, ops, F, dev, tag, B, H, Hkv, Dqk, Dv, nope, seed,
              Sq=None, Skv=None, causal=True) -> dict:
    """K4 at a rank's shape (bf16; q of Sq rows over Skv keys, causal or
    not, both PREFILL_S by default; MLA's v a slice of kv_b's rows, as
    ``mla_attention`` passes it)
    against its plain version (``k4_yardstick``: p in f32 within 2e-2,
    and with p rounded to bf16 as the kernel rounds it, within 2e-2 too),
    its profiler device time beside ``scaled_dot_product_attention``'s
    and its bound; q, k and v laid out as the model passes them (heads
    the second dim of a (B, S, heads, ·) tensor; v after ``nope`` columns
    of each head's row)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Sq, Skv = Sq or PREFILL_S, Skv or PREFILL_S

    def heads(h, s, d, skip=0):
        return torch.randn(B, s, h, skip + d, generator=gen, device=dev,
                           dtype=torch.bfloat16)[..., skip:].transpose(1, 2)
    q, k, v = heads(H, Sq, Dqk), heads(Hkv, Skv, Dqk), heads(Hkv, Skv, Dv,
                                                            nope)
    err, err_r, _ms, plain, _lib, _got = k4_yardstick(torch, ops, F, q, k,
                                                      v, causal)
    what = f"{tag}'s rank shape ({'causal' if causal else 'not causal'}, " \
        f"Sq {Sq}, Skv {Skv})"
    check(err_r <= 2e-2, f"[family-mesh] K4 at {what}: max |d| "
          f"{err_r:.3e} to the plain version with p in bf16")
    times = k4_rank_times(torch, ops, F, q, k, v, causal)
    assert Sq == Skv or not causal     # a causal mask aligned top-left
    pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Skv)
    flops = 2 * (Dqk + Dv) * pairs
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * H * Sq * Dv)
    bms, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    rec = dict(model=tag, shape=[B, H, Hkv, Sq, Skv, Dqk, Dv],
               causal=causal, max_abs_err=err, max_abs_err_p_bf16=err_r,
               ms=times["k4_device"], plain_ms=plain, bound_ms=bms,
               bound_by=by, library_ms=times["sdpa_device"],
               timed_by=timed_by(times["k4_device"], times["sdpa_device"]))
    log(f"[K4] {what} q {tuple(q.shape)} k {tuple(k.shape)} v "
        f"{tuple(v.shape)}: max |d| {err:.3e} (p in bf16: {err_r:.3e}); "
        f"device time {rec['ms']:.4f} ms/launch = "
        f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms ({by}), "
        f"{bms / rec['ms']:.1%} of it; plain {plain:.3f} ms; "
        f"scaled_dot_product_attention device time "
        f"{rec['library_ms']:.4f} ms; {times}")
    del q, k, v
    torch.cuda.empty_cache()
    return rec


def family_mesh_phase(torch, ops, dev, rows) -> None:
    """``[family-mesh]``, after ``[vlm]`` with every earlier phase's
    weights freed: deepseek-v3 (MLA + MoE), mamba2-130m (SSD) and
    seamless-m4t-large-v2 (encoder–decoder) served tensor- and
    sequence-parallel over make_test_mesh(2, 4), 8 ranks sharing this card
    over gloo in one spawn, then jamba (the hybrid) on that spawn's first
    data line, a (1, 4) mesh; each at published width in bf16
    (FM_* give the depths), held to the one card's answers on the same
    draws."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    models, want, cfgs, positions = [], {}, {}, {}
    for tag, cfg, small, dims in family_mesh_models(get_config):
        batch, f32_batch, prompt = family_batches(torch, np, cfg, rng)
        positions[tag] = sum(x.shape[1] for x in batch.values())
        t = time.perf_counter()
        want[tag] = family_one_card(torch, dev, cfg, small, batch,
                                    f32_batch, prompt, FM_SSD_DEPTH.get(tag))
        cfgs[tag] = (cfg, small, dims)
        log(f"[family-mesh] {tag}: the one card's answers on the same draws "
            f"({want[tag]['weight_bytes'] / 1e9:.3f} GB of bf16 weights) in "
            f"{time.perf_counter() - t:.1f} s")
        models.append((tag, cfg, small, batch, f32_batch, prompt, dims))

    # K4 at the MLA and jamba ranks' prefill shapes, alone on the card
    ds, jb = cfgs["deepseek"][0], cfgs["jamba"][0]
    m = ds.mla
    k4_mla = family_k4(torch, ops, F, dev, "deepseek",
                       PREFILL_B // MESH_DATA, ds.n_heads // MESH_MODEL,
                       ds.n_heads // MESH_MODEL, m.nope_dim + m.rope_dim,
                       m.v_dim, m.nope_dim, 41)
    k4_hyb = family_k4(torch, ops, F, dev, "jamba", PREFILL_B,
                       jb.n_heads // MESH_MODEL,
                       max(1, jb.n_kv_heads // MESH_MODEL), jb.hd, jb.hd, 0,
                       42)
    # seamless's ranks: the encoder's self-attention and the decoder's
    # cross-attention not causal (ENCDEC_S tokens over ENCDEC_SRC frames,
    # both 1,024), the decoder's self-attention causal, the decode's
    # cross-attention one q row over the memory's frames
    sm = cfgs["seamless"][0]
    sm_rank = (sm.n_heads // MESH_MODEL,
               max(1, sm.n_kv_heads // MESH_MODEL), sm.hd, sm.hd, 0)
    k4_sm = [family_k4(torch, ops, F, dev, "seamless", b, *sm_rank, seed,
                       Sq=sq, Skv=skv, causal=c)
             for b, sq, skv, c, seed in (
                 (PREFILL_B // MESH_DATA, ENCDEC_S, ENCDEC_SRC, False, 43),
                 (PREFILL_B // MESH_DATA, ENCDEC_S, ENCDEC_S, True, 44),
                 (SERVE_B // MESH_DATA, 1, ENCDEC_SRC, False, 45))]

    note = ("ranks share this one card over gloo (staged through host "
            "memory): these times measure that transport, not an "
            "interconnect")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[family-mesh] before the spawn: {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB free on the card, this process "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} reserved")
    t, wall = time.perf_counter(), time.time()
    out = run_on_ranks(family_mesh_job, make_test_mesh(MESH_DATA, MESH_MODEL),
                       models, timeout=900)
    log(f"[family-mesh] {MESH_DATA * MESH_MODEL} ranks of make_test_mesh("
        f"{MESH_DATA}, {MESH_MODEL}) on this card over gloo in one spawn "
        f"(each model on the mesh its line below names, a (1, "
        f"{MESH_MODEL}) one on the first data line's ranks): "
        f"{time.perf_counter() - t:.1f} s, of which "
        f"{out['started'] - wall:.1f} s until every rank ran")
    reports = [r for rank in out["reports"] for r in rank]
    for tag in dict.fromkeys(r["tag"] for r in reports):
        dry_verdict(f"[family-mesh] {tag}",
                    [r for r in reports if r["tag"] == tag])
    got = {k: v for k, v in out.items() if isinstance(k, tuple)}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    # each model's K4 launches go to the row of its head dims (deepseek
    # MLA's 192/128, seamless's D 64, jamba's D 128); mamba2 has none
    row = {r["name"]: r for r in rows}
    row = {"deepseek": row["flash_attention_mla"],
           "seamless": row["flash_attention_encdec"],
           "jamba": row["flash_attention"]}
    launches, by_phase = dict.fromkeys(row, 0), {}
    for tag, (cfg, small, dims) in cfgs.items():
        mine = [r for r in reports if r["tag"] == tag]
        w = want[tag]
        e_pre = rel(got[tag, "f32_logits"], w["f32_logits"])
        e_dec = rel(got[tag, "f32_steps"], w["f32_steps"])
        check(e_pre <= 1e-4 and e_dec <= 1e-4, f"[family-mesh] {tag} f32: "
              f"the mesh's logits are {e_pre:.3e} (prefill) and {e_dec:.3e} "
              "(decode) of the largest from the one card's")
        e_check = rel(got[tag, "check_logits"], w["check_logits"])
        check(e_check <= 2e-2, f"[family-mesh] {tag} bf16 at one layer: "
              f"prefill logits {e_check:.3e} of the largest from the one "
              "card's")
        e_bf16 = rel(got[tag, "logits"], w["logits"])
        check(got[tag, "logits"].shape == w["logits"].shape and bool(
            torch.isfinite(got[tag, "logits"]).all()) and (
                e_bf16 <= 2e-2 or tag in FM_SSD_STACKS),
            f"[family-mesh] {tag} bf16 prefill logits {e_bf16:.3e} of the "
            "largest from the one card's")
        depth = ""
        if tag in FM_SSD_DEPTH:      # the first layers against their twin
            n = FM_SSD_DEPTH[tag]
            one = rel(w["depth_logits"], w["depth_twin"])
            on_mesh = rel(got[tag, "depth_logits"], w["depth_twin"])
            to_one = rel(got[tag, "depth_logits"], w["depth_logits"])
            check(max(one, on_mesh) <= FM_SSD_TWIN_TOL, f"[family-mesh] "
                  f"{tag}'s first {n} layers in bf16 against their f32 "
                  f"twin: the one card {one:.3e}, the mesh {on_mesh:.3e} "
                  f"(at most {FM_SSD_TWIN_TOL})")
            depth = (f"; its first {n} layers' bf16 prefill logits to their "
                     f"f32 twin (tolerance {FM_SSD_TWIN_TOL}): the one card "
                     f"{one:.3e}, the mesh {on_mesh:.3e} "
                     f"({on_mesh / one:.2f}x), the mesh to the one card "
                     f"{to_one:.3e}")
        served = got[tag, "served"]
        check(served.finite and served.tokens.shape == (SERVE_B, FM_TOKENS)
              and int(served.tokens.max()) < cfg.vocab, f"[family-mesh] "
              f"{tag} decode output")
        agree = int((served.tokens == w["tokens"]).sum())
        # K4: once an attention layer a rank in prefill (MLA on its own
        # row); in decode only the cross-attention, once a decoder layer
        k4_pre = {"deepseek": cfg.n_layers, "mamba2": 0, "jamba": 1,
                  "seamless": cfg.n_encoder_layers + 2 * cfg.n_layers}[tag]
        k4_dec = cfg.n_layers * served.steps if tag == "seamless" else 0
        pre_sites, dec_sites = FM_SITES[tag]
        for r in mine:
            for phase, n, sites in (("prefill", k4_pre, pre_sites),
                                    ("decode", k4_dec, dec_sites)):
                ran = {k: v for k, v in r[phase]["launches"].items() if v}
                check(ran == ({"flash_attention": n} if n else {}),
                      f"[family-mesh] {tag} rank {r['coords']} {phase} "
                      f"launched {ran}, not K4 {n} times")
                check(sites <= set(r[phase]["collectives"]), f"[family-mesh]"
                      f" {tag} rank {r['coords']} {phase} called no "
                      f"{sorted(sites - set(r[phase]['collectives']))}")
            plan = r["plan"]
            split = {"deepseek": plan["heads"][1] == plan["hp"] // MESH_MODEL
                     and plan["experts"] and plan["rows"],
                     "mamba2": plan["ssd"],
                     "jamba": plan["ssd"] and plan["experts"],
                     "seamless": plan["heads"][1] == plan["hp"] // MESH_MODEL
                     and plan["ffn"]}[tag]
            check(split and plan["vocab"], f"[family-mesh] {tag} rank "
                  f"{r['coords']}: plan {plan}")
        if tag in launches:
            by_phase[tag] = [sum(r[ph]["launches"].get("flash_attention", 0)
                                 for r in mine)
                             for ph in ("prefill", "decode")]
            launches[tag] = sum(by_phase[tag])
        t_pre = max(r["prefill"]["s"] for r in mine)
        ms_step = max(r["decode"]["s"] for r in mine) * 1e3 / served.steps
        B, S = got[tag, "logits"].shape[0], positions[tag]
        log(f"[family-mesh] {tag} ({cfg.name}, {cfg.n_layers} layers"
            + (f" + {cfg.n_encoder_layers} encoder layers" if
               cfg.n_encoder_layers else "")
            + f" at published width) on make_test_mesh{dims}: f32 at the "
            f"check's depth ({small.n_layers} layers"
            + (f", a period of {small.attn_period}" if small.attn_period
               else "")
            + f") prefill logits {e_pre:.3e} and {MESH_F32_STEPS} decode "
            f"steps' {e_dec:.3e} of the largest |logit| from the one "
            f"card's (tolerance 1e-4); bf16 prefill {B} x {S} positions "
            f"({B // dims[0]} rows a data rank) {t_pre * 1e3:.1f} ms (the "
            f"slowest rank), logits {e_bf16:.3e} of the largest from the "
            f"one card's ("
            + ("a random SSD stack at depth: logged" if tag in FM_SSD_STACKS
               else "tolerance 2e-2") + f"{depth});"
            f" at one layer in bf16 {e_check:.3e} (tolerance 2e-2); decode "
            f"B={SERVE_B}, prompt "
            f"{FM_PROMPT} + {FM_TOKENS} greedy tokens: {ms_step:.3f} "
            f"ms/token-step (the slowest rank), every logit finite; "
            f"{agree} of {served.tokens.numel()} greedy tokens equal the "
            f"one card's (not gated); K4 {k4_pre} launches a rank in "
            f"prefill, {k4_dec} in decode; {note}")
        for r in mine:
            sites = {ph: {site: (round(c["seconds"], 4), c["bytes"],
                                 c["calls"])
                          for site, c in r[ph]["collectives"].items()}
                     for ph in ("prefill", "decode")}
            log(f"[family-mesh] {tag} rank {r['coords']}: weights "
                f"{r['weight_bytes'] / 1e9:.3f} GB built in "
                f"{r['init_s']:.1f} s (peak {r['init_peak_gib']:.2f} GiB; "
                f"{r['free_gib']:.2f} GiB free on the card before); "
                f"prefill {r['prefill']['s'] * 1e3:.1f} ms, decode "
                f"{r['decode']['s'] * 1e3 / served.steps:.3f} ms/token-step,"
                f" peak {r['prefill']['peak_gib']:.2f} / "
                f"{r['decode']['peak_gib']:.2f} GiB; {r['model_s']:.1f} s "
                f"in all; collectives (seconds, bytes, calls) by site "
                f"{json.dumps(sites)}; plan {json.dumps(r['plan'])}")

    for tag, n in launches.items():
        row[tag]["launches"] += n
    row["deepseek"]["mesh_shape"] = dict(k4_mla, launches=launches[
        "deepseek"])
    row["jamba"]["family_mesh_shape"] = dict(k4_hyb, launches=launches[
        "jamba"])
    # seamless's prefill launches at its two shapes: the encoder's and
    # the cross-attention's not causal, the decoder's causal (checked a
    # rank above); its decode's at Sq = 1
    pre, dec = by_phase["seamless"]
    ranks = pre // (sm.n_encoder_layers + 2 * sm.n_layers)
    row["seamless"]["family_mesh_shapes"] = [
        dict(rec, launches=n) for rec, n in zip(k4_sm, (
            ranks * (sm.n_encoder_layers + sm.n_layers),
            ranks * sm.n_layers, dec))]
    log(f"[family-mesh] K4 launches on the ranks' paths: {launches} "
        f"(rows flash_attention_mla, flash_attention_encdec, "
        f"flash_attention); phase {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import CLUGPConfig, metrics, web_graph
    from repro_torch.core.clustering import (localize_stream,
                                             streaming_clustering)
    from repro_torch.core.game import cluster_csr
    from repro_torch.core.partitioner import partition
    from repro_torch.core.stages import (cluster_graph_arrays,
                                         lambda_from_totals)
    from repro_torch.core.transform import majority_vertex_map
    from repro_torch.graph.engine import reference_pagerank
    from repro_torch.kernels import ops
    from repro_torch.session import GraphSession, SessionConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------- phase 1
    log(smi("name,power.limit"))
    sm_mhz = smi("clocks.max.sm")
    sm_hz = float(sm_mhz.split()[0]) * 1e6
    log(f"top SM clock {sm_mhz}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    report = ops.build_all()
    log(f"[build] {time.perf_counter() - t:.1f} s")
    for name, r in report.items():
        entries = ptxas_entries(r["ptxas"])
        log(f"[build] {name}: {r['seconds']:.1f} s "
            f"{'cached' if r['cached'] else ''} " + " | ".join(
                f"{k} {regs} registers, {spill} B spilled"
                for k, regs, spill in entries))
        check(name != "flash_attention_bwd" or (entries and not any(
            spill for *_, spill in entries)), f"{name} spills registers "
            f"(or ptxas reported nothing): {entries}")

    # ---------------------------------------------------------- phase 2
    t = time.perf_counter()
    g = web_graph(scale=SCALE, edge_factor=EDGE_FACTOR, seed=0)
    E, V = g.num_edges, g.num_vertices
    log(f"[graph] scale {SCALE}: V={V} E={E}, top in-degree "
        f"{int(np.bincount(g.dst).max())} ({time.perf_counter() - t:.1f} s)")
    cfg = CLUGPConfig.optimized(K, restream=1)
    sess = GraphSession(SessionConfig(clugp=cfg, backend="torch",
                                      exchange="halo", iters=30))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.partition(g.src, g.dst, V)
    t1 = time.perf_counter()
    sess.layout()
    t2 = time.perf_counter()
    pr = sess.run("pagerank")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.launch_counts()
    log(f"[main] launches {json.dumps(launches)}")
    check_path_launches(ops, launches, "graph")
    check(launches.get("game_bestresponse", 0) == 0,
          "the game launched the dense K2 (it runs the CSR form)")
    passes = 1 + sess.stats["cap_retries"]    # one clustering pass a try
    check(launches["cluster_scatter"] == passes,
          f"K1 launched {launches['cluster_scatter']} times for {passes} "
          "clustering passes, not once per pass")
    t = time.perf_counter()
    sess.run("pagerank")
    torch.cuda.synchronize()
    pr_steady = time.perf_counter() - t
    log(f"[main] pagerank again on the cached device tables: "
        f"{pr_steady * 1e3 / 30:.3f} ms/iteration")
    st = sess.stats
    stages = dict(st["stage_seconds"])
    stages.update(layout=t2 - t1, pagerank=t3 - t2)
    log("[main] seconds " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))
    log("[main] us/edge " + json.dumps(
        {k: round(v * 1e6 / E, 4) for k, v in stages.items()}))
    log(f"[main] partition {t1 - t0:.3f} s, layout {t2 - t1:.3f} s, "
        f"pagerank {t3 - t2:.3f} s, total {t3 - t0:.3f} s = "
        f"{(t3 - t0) * 1e6 / E:.3f} us/edge; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    rf_random = metrics.replication_factor(
        g.src, g.dst, rng.integers(0, K, E).astype(np.int32), V, K)
    log(f"[main] rf {st['rf']:.4f} (uniform random {rf_random:.4f}), "
        f"balance {st['balance']:.4f}, clusters {st['num_clusters']}, "
        f"m_cap {st['m_cap']}, id_cap {st['id_cap']}, "
        f"game rounds {st['game_rounds']}, cap retries {st['cap_retries']}")
    check(st["rf"] < rf_random, "RF not below a random assignment's")
    check(max(st["sizes"]) <= cfg.tau * E / K + 1, "balance cap broken")
    check(pr.shape == (V,) and np.isfinite(pr).all(), "PageRank not finite")
    ref = reference_pagerank(g.src, g.dst, V, 30)
    l1 = float(np.abs(pr.astype(np.float64) - ref).sum())
    log(f"[main] pagerank L1 vs float64 oracle {l1:.3e}")
    check(l1 <= 1e-4, f"PageRank L1 {l1} > 1e-4")
    main_assign = sess.assign.copy()      # the sweep's k = K entry's witness

    # ---------------------------------------------------------- phase 2b
    dist_k3 = dist_phase(g, sess.result, t1 - t0, ref)

    # ---------------------------------------------------------- phase 3
    gas = gas_phase(torch, ops, sess, g)
    exch = exchange_phase(torch, ops, sess, g, gas)
    del gas["halo"], gas["cc40"], gas["refs"]

    # ---------------------------------------------------------- phase 4
    rows = []
    vmax = max(2.0, E / float(K))
    src_t = torch.from_numpy(g.src).to(dev)
    dst_t = torch.from_numpy(g.dst).to(dev)

    # K1: the pass over the scale-20 stream (one launch), held against its
    # plain version on the first PASS_PREFIX blocks, timed over the whole
    # stream
    ints, uvg = localize_stream(src_t, dst_t, V)
    nb, B = ints.shape[0], ints.shape[1]
    cap = st["id_cap"]

    def fresh_state():
        return (torch.full((V + 1,), -1, dtype=torch.int32, device=dev),
                torch.zeros(V + 1, dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=torch.int32, device=dev),
                torch.zeros(4, dtype=torch.int32, device=dev))

    def run_pass(fn, n, state):
        return fn(ints[:n], uvg[:n], *state, vmax,
                  split_degree_factor=cfg.split_degree_factor)
    pre = min(PASS_PREFIX, nb)
    got_state, exp_state = fresh_state(), fresh_state()
    got = (*got_state, run_pass(ops.cluster_pass, pre, got_state))
    torch.cuda.synchronize()
    t = time.perf_counter()
    exp = (*exp_state, run_pass(ops.cluster_pass_plain, pre, exp_state))
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t) * 1e3
    err = 0
    for name, a, b_ in zip(("clu", "deg", "vol", "scal", "packed"), got, exp):
        d = int((a.long() - b_.long()).abs().max())
        check(d == 0, f"K1 pass differs from its plain version in {name} "
              f"(max |d| {d}) on the first {pre} blocks")
        err = max(err, d)
    prefix_ms = event_ms(torch, lambda: run_pass(ops.cluster_pass, pre,
                                                 fresh_state()), 3, warmup=1)
    runs = []
    for _ in range(2):               # the whole stream, from fresh state
        state = fresh_state()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_pass(ops.cluster_pass, nb, state)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    ms = sum(runs) / len(runs)
    live = int(ints[..., 2].sum())
    # each input read once, each output written once: the localized rows
    # and slots, clu/deg (V + 1) and vol (cap) read and written, scal,
    # packed
    nbytes = 4 * (ints.numel() + uvg.numel() + 4 * (V + 1) + 2 * cap + 8
                  + nb * B)
    bms, by = bound_ms(nbytes, K1_OPS_PER_EDGE * live)
    lat = latency_ms(live, K1_STEPS_PER_EDGE, sm_hz)
    rows.append(dict(name="cluster_scatter", route="cuda",
                     source="src/repro_torch/csrc/cluster_scatter.cu",
                     replaces="src/repro/kernels/cluster_scatter.py:188",
                     launches=launches["cluster_scatter"], max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None, latency_bound_ms=lat,
                     limited_by="latency", blocks=nb, plain_blocks=pre,
                     prefix_ms=prefix_ms))
    log(f"[K1] pass over {nb} blocks ({live} live edges): {ms:.3f} ms "
        f"(runs {', '.join(f'{r:.3f}' for r in runs)}) = "
        f"{ms * 1e3 / nb:.3f} us/block; bit-identical to the plain pass on "
        f"the first {pre} blocks (kernel {prefix_ms:.3f} ms, plain "
        f"{plain:.1f} ms); bound {bms:.5f} ms ({by}), latency floor "
        f"{lat:.3f} ms ({live} live edges x {K1_STEPS_PER_EDGE} x "
        f"{SMEM_STEP_CYCLES} cycles)")
    del ints, uvg, got, exp, got_state, exp_state

    # K2 at M = m_cap, k = 64 (the game passes kpad = k)
    M = st["m_cap"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    aff = torch.randint(0, 4, (M, K), generator=gen, device=dev
                        ).to(torch.float32)
    sizes = torch.randint(1, 200, (M,), generator=gen, device=dev
                          ).to(torch.float32)
    row_tot = aff.sum(1) + torch.randint(0, 8, (M,), generator=gen,
                                         device=dev).to(torch.float32)
    cur = torch.randint(0, K, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    loads = torch.randint(150000, 250000, (K,), generator=gen,
                          device=dev).to(torch.float32)
    lam = torch.tensor([0.05], device=dev)
    kb, kc = ops.game_bestresponse(aff, sizes, row_tot, cur, loads, lam=lam,
                                   k=K)
    pb, pc = ops.game_bestresponse_plain(aff, sizes, row_tot, cur, loads,
                                         lam=lam, k=K)
    differ = kb != pb
    near_tie = (pc[differ] - kc[differ]).abs() <= 1e-6 * kc[differ].abs()
    check(bool(near_tie.all()), "K2 best differs beyond near-ties")
    torch.testing.assert_close(kc, pc, rtol=1e-6, atol=0.0)
    k2_err = float((kc - pc).abs().max())
    def dense():
        return ops.game_bestresponse(aff, sizes, row_tot, cur, loads,
                                     lam=lam, k=K)
    ms = device_ms(torch, dense, 50, "game_bestresponse_kernel")
    launch_ms = event_ms(torch, dense, 50)
    plain = event_ms(torch, lambda: ops.game_bestresponse_plain(
        aff, sizes, row_tot, cur, loads, lam=lam, k=K), 10)
    nbytes = M * K * 4 + M * 12 + K * 4 + 4 + M * 8
    bms, by = bound_ms(nbytes, K2_OPS_PER_LANE * M * K)
    rows.append(dict(name="game_bestresponse", route="cuda",
                     source="src/repro_torch/csrc/game_bestresponse.cu",
                     replaces="src/repro/kernels/game_bestresponse.py:52",
                     launches=launches.get("game_bestresponse", 0),
                     max_abs_err=k2_err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     limited_by="bytes", launch_ms=launch_ms))
    log(f"[K2] M={M} k={K}: {int(differ.sum())} best flips (all "
        f"near-ties), cost max |d| {k2_err:.3e}; {ms:.4f} ms/launch on the "
        f"device ({launch_ms:.4f} ms a call back to back)")
    del aff

    # the fused K2 on every live batch of the run's game: its cluster CSR,
    # final assignment and the loads that assignment gives
    clus = sess.result.clustering
    gstate = cluster_graph_arrays(src_t, dst_t,
                                  torch.from_numpy(clus.clu).to(dev), M,
                                  cfg.effective_sizes)
    real = (gstate.xs < M) & (gstate.xd < M)
    rowptr, col = cluster_csr(gstate.xs[real].long(), gstate.xd[real].long(),
                              M)
    n_cross = int(real.sum())
    m = st["num_clusters"]
    g_assign = torch.zeros(M, dtype=torch.int32, device=dev)
    g_assign[:m] = torch.from_numpy(sess.result.cluster_assign).to(dev)
    g_loads = torch.zeros(K, device=dev).index_add_(0, g_assign.long(),
                                                    gstate.sizes)
    g_lam = lambda_from_totals(gstate.sizes.sum(), gstate.n_cross, K,
                               cfg.relative_weight).reshape(1)
    bs = cfg.batch_size
    batches = [(r0, min(r0 + bs, M)) for r0 in range(0, m, bs)]
    n_batches = -(-M // bs)
    csr_err = 0.0
    for r0, r1 in batches:
        got = ops.game_bestresponse_csr(rowptr, col, g_assign, gstate.sizes,
                                        gstate.row_tot, g_loads, lam=g_lam,
                                        k=K, row0=r0, row1=r1)
        exp = ops.game_bestresponse_csr_plain(
            rowptr, col, g_assign, gstate.sizes, gstate.row_tot, g_loads,
            lam=g_lam, k=K, row0=r0, row1=r1)
        for name, a_, b_ in zip(("best", "cost", "cost_cur"), got, exp):
            check(torch.equal(a_, b_), f"fused K2 differs from its plain "
                  f"version in {name} on rows {r0}..{r1}")
            csr_err = max(csr_err, float((a_.double() - b_.double())
                                         .abs().max()))

    def all_batches(fn):
        return lambda: [fn(rowptr, col, g_assign, gstate.sizes,
                           gstate.row_tot, g_loads, lam=g_lam, k=K, row0=r0,
                           row1=r1) for r0, r1 in batches]
    ms = device_ms(torch, all_batches(ops.game_bestresponse_csr), 20,
                   "game_bestresponse_csr_kernel")
    launch_ms = event_ms(torch, all_batches(ops.game_bestresponse_csr), 20) \
        / len(batches)
    per_batch = [device_ms(torch, lambda r0=r0, r1=r1: ops.game_bestresponse_csr(
        rowptr, col, g_assign, gstate.sizes, gstate.row_tot, g_loads,
        lam=g_lam, k=K, row0=r0, row1=r1), 10, "game_bestresponse_csr_kernel")
        for r0, r1 in batches]
    row_len = (rowptr[1:] - rowptr[:-1]).long()
    longest = int(row_len.max())
    log(f"[K2-CSR] ms per live batch {[round(x, 4) for x in per_batch]}; "
        f"longest row {longest} entries (row {int(row_len.argmax())}), "
        f"rows over 4,096 entries: {int((row_len > 4096).sum())}")
    plain = event_ms(torch, all_batches(ops.game_bestresponse_csr_plain), 3,
                     warmup=1) / len(batches)
    rp = rowptr.long()
    entries = int(rp[batches[-1][1]] - rp[0])      # every live row's entries
    rows_live = batches[-1][1]
    # per launch: the CSR entries and one assign gather each, each row's
    # rowptr pair, size, row total and own assign, three outputs, the loads
    nbytes = (8 * entries + 4 * (rows_live + len(batches)) + 12 * rows_live
              + 12 * rows_live + (4 * K + 4) * len(batches)) / len(batches)
    nops = (K2_OPS_PER_ENTRY * entries + K2_OPS_PER_LANE * rows_live * K) \
        / len(batches)
    bms, by = bound_ms(nbytes, nops)
    rows.append(dict(name="game_bestresponse_csr", route="cuda",
                     source="src/repro_torch/csrc/game_bestresponse_csr.cu",
                     replaces="src/repro/kernels/game_bestresponse.py:52",
                     launches=launches["game_bestresponse_csr"],
                     max_abs_err=csr_err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     launch_ms=launch_ms, live_batches=len(batches),
                     batches=n_batches, n_cross=n_cross,
                     batch_ms=per_batch))
    log(f"[K2-CSR] {len(batches)} of {n_batches} batches hold a live row "
        f"({m} clusters, m_cap {M}); n_cross {n_cross} ({2 * n_cross} CSR "
        f"entries, {entries} in the live rows); bit-identical on best, cost "
        f"and cost_cur; {ms:.4f} ms/launch on the device (mean over the live "
        f"batches; {launch_ms:.4f} ms a call back to back), plain "
        f"{plain:.3f} ms; bound {bms:.5f} ms ({by}) = "
        f"{bms / ms:.1%}; the game's {launches['game_bestresponse_csr']} "
        f"launches x {ms:.4f} ms = "
        f"{launches['game_bestresponse_csr'] * ms / 1e3:.3f} s")
    del gstate, rowptr, col, rp

    # K3 on the run's row-split ELL table
    lay = sess.partition_layout
    ell = lay.cache[(str(dev), "halo")]["ell"]
    R, W = ell.vals.shape
    N = lay.k * (lay.l_max + 1)
    x = torch.rand(N, generator=gen, device=dev)
    y = ops.ell_spmv(ell.vals, ell.cols, x)
    yp = ops.ell_spmv_plain(ell.vals, ell.cols, x)
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-6)
    k3_err = float((y - yp).abs().max())
    ms = device_ms(torch, lambda: ops.ell_spmv(ell.vals, ell.cols, x), 50,
                   "ell_spmv_kernel")
    launch_ms = event_ms(torch, lambda: ops.ell_spmv(ell.vals, ell.cols, x),
                         50)
    plain = event_ms(torch, lambda: ops.ell_spmv_plain(ell.vals, ell.cols,
                                                       x), 10)
    # the same function as a CSR matrix of the real lanes (PyTorch's CSR
    # wants sorted, distinct columns per row; pad lanes add 0 anyway)
    real = ell.vals.reshape(-1) != 0
    r_idx = torch.arange(R, device=dev).repeat_interleave(W)[real]
    c_idx = ell.cols.reshape(-1).long()[real]
    order = torch.argsort(r_idx * N + c_idx)
    crow = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(r_idx, minlength=R), 0)
    with warnings.catch_warnings():      # "beta state" notices
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(crow, c_idx[order],
                                      ell.vals.reshape(-1)[real][order],
                                      size=(R, N), check_invariants=True)
    xs = x[:, None]
    lib = event_ms(torch, lambda: torch.sparse.mm(csr, xs), 20)
    torch.testing.assert_close(torch.sparse.mm(csr, xs)[:, 0], yp,
                               rtol=1e-5, atol=1e-6)
    bms, by = bound_ms(R * W * 8 + N * 4 + R * 4, 2 * R * W)
    rows.append(dict(name="ell_spmv", route="cuda",
                     source="src/repro_torch/csrc/ell_spmv.cu",
                     replaces="src/repro/kernels/ell_spmv.py:30",
                     launches=launches["ell_spmv"], max_abs_err=k3_err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib, limited_by="bytes", launch_ms=launch_ms,
                     gas_launches=gas["k3"], exchange_launches=exch["k3"],
                     dist_launches=dist_k3["ranks"],
                     dryrun_launches=dist_k3["dryrun"]))
    log(f"[K3] R={R} W={W} N={N}: max |d| {k3_err:.3e}; {ms:.4f} ms/launch "
        f"on the device ({launch_ms:.4f} ms a call back to back), "
        f"torch.sparse.mm {lib:.4f} ms")

    # T on the main path's two walks: the first pass's inputs (the game's
    # cluster partitions as the prior) and the restream pass's (the first
    # pass's majority map); its time depends on the data through the tiers
    lmax = cfg.tau * E / K
    deg_t = torch.from_numpy(clus.deg).to(dev)
    div_t = torch.from_numpy(clus.divided).to(dev)
    ca = torch.from_numpy(sess.result.cluster_assign).to(dev)
    priors = {
        "first": ca[torch.from_numpy(clus.clu).to(dev).clamp(0, m - 1).long()],
        "restream": majority_vertex_map(
            src_t, dst_t, torch.from_numpy(sess.assign).to(dev), V, K)}
    t_rows = {}
    for name, vp in priors.items():
        pu, pv, nm = ops.transform_inputs(src_t.long(), dst_t.long(), vp,
                                          deg_t, div_t)
        got, tiers = ops.transform_scan_tiers(pu, pv, nm, K, lmax)
        t = time.perf_counter()
        exp = ops.transform_scan_plain(pu, pv, nm, K, lmax)
        plain = (time.perf_counter() - t) * 1e3
        t_err = int((got.long() - exp.long()).abs().max())
        check(t_err == 0, f"T differs from its plain version ({name} pass)")
        t = time.perf_counter()
        emu, emu_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, K, lmax)
        emu_s = time.perf_counter() - t
        check(torch.equal(got, emu), f"T differs from the tiered emulation "
              f"({name} pass)")
        check(tiers == emu_tiers, f"T's tier counts {tiers} differ from the "
              f"emulation's {emu_tiers} ({name} pass)")
        ms = event_ms(torch, lambda: ops.transform_scan(pu, pv, nm, K, lmax),
                      5, warmup=1)
        steps = (tiers["frozen_edges"] + tiers["exact_edges"]) \
            / T_WALK_STEP + tiers["both_edges"]
        lat = latency_ms(steps, 1, sm_hz)
        t_rows[name] = dict(ms=ms, plain=plain, tiers=tiers, lat=lat,
                            real=int((nm >= 0).sum()), err=t_err)
        log(f"[T] {name} pass, E={E}: bit-identical to the plain walk and the "
            f"tiered emulation ({emu_s:.1f} s); tiers {json.dumps(tiers)}; "
            f"{ms:.3f} ms/launch (the one-thread walk: {T_ONE_THREAD_MS} ms, "
            f"{T_ONE_THREAD_MS / ms:.1f}x), plain loop {plain:.0f} ms; latency "
            f"floor {lat:.3f} ms ({steps:.0f} dependent steps x "
            f"{SMEM_STEP_CYCLES} cycles)")
        del pu, pv, nm, got, exp, emu
    ms = sum(r["ms"] for r in t_rows.values()) / len(t_rows)
    real = sum(r["real"] for r in t_rows.values()) / len(t_rows)
    bms, by = bound_ms(E * 16, T_OPS_PER_EDGE * real)
    lat = sum(r["lat"] for r in t_rows.values()) / len(t_rows)
    rows.append(dict(name="transform_scan", route="cuda",
                     source="src/repro_torch/csrc/transform_scan.cu",
                     replaces="src/repro/core/transform.py:93",
                     launches=launches["transform_scan"],
                     max_abs_err=max(r["err"] for r in t_rows.values()),
                     ms=ms, plain_ms=sum(r["plain"] for r in t_rows.values())
                     / len(t_rows), bound_ms=bms, bound_by=by,
                     library_ms=None, latency_bound_ms=lat,
                     limited_by="latency",
                     passes={n: dict(ms=r["ms"], tiers=r["tiers"])
                             for n, r in t_rows.items()}))
    log(f"[T] mean over the path's two walks {ms:.3f} ms/launch; bound "
        f"{bms:.4f} ms ({by}) plus the walks' dependent steps {lat:.3f} ms")

    # the wires' device activities an iteration, profiled after the
    # kernel timings above
    per_iter = exchange_activities(torch, sess)
    log("[exchange] device activities an iteration (profiler): " + "; ".join(
        f"{n} on {e} " + ("not measured" if c is None else f"{c:.1f}")
        for (n, e), c in per_iter.items()))

    # ---------------------------------------------------------- phase 4b
    # the serving phase swaps the session's layout: drop what phase 4 held
    # of the old one first
    del lay, ell, x, y, yp, csr, crow, r_idx, c_idx, order, xs, real
    del src_t, dst_t, deg_t, div_t, ca, priors, clus
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    graph_serve_phase(torch, ops, sess, g, rows[-1])
    # the grown session goes with its layout and device tables, so the
    # LM phases' peaks hold no graph state (the resident memory it held
    # is logged here)
    grown = torch.cuda.memory_allocated()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[graph-serve] resident device memory: {resident / 2**30:.3f} GiB "
        f"before the phase, {grown / 2**30:.3f} after it, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} with the session "
        "dropped")

    # ---------------------------------------------------------- phase 5
    gs = web_graph(scale=SMALL_SCALE, edge_factor=EDGE_FACTOR, seed=0)
    ss = torch.from_numpy(gs.src).to(dev)
    sd = torch.from_numpy(gs.dst).to(dev)
    vs = max(2.0, gs.num_edges / float(K))
    t_kernel = host_ms(torch, lambda: streaming_clustering(
        ss, sd, gs.num_vertices, vs, kernel="cuda")) / 1e3
    a = streaming_clustering(ss, sd, gs.num_vertices, vs, kernel="cuda")
    t = time.perf_counter()
    b = streaming_clustering(ss, sd, gs.num_vertices, vs, kernel="torch")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t
    for x_, y_ in zip(a, b):
        check(torch.equal(x_, y_), "scale-16 clustering state differs")
    results = {}
    for game in (False, True):
        for mode in ("cuda", "torch"):
            c = CLUGPConfig.optimized(K, restream=1, game=game, kernel=mode,
                                      cluster_kernel=mode)
            results[game, mode] = partition(gs.src, gs.dst, gs.num_vertices,
                                            c)
        check(np.array_equal(results[game, "cuda"].assign,
                             results[game, "torch"].assign),
              f"scale-16 assignment (game={game}) differs between kernel "
              "and plain")
    on = results[True, "cuda"].stats
    # the same partitions on the CPU: the game's start and damping draws
    # are a counter hash of (seed, stream, row), the same on every device
    for game in (False, True):
        c = CLUGPConfig.optimized(K, restream=1, game=game, kernel="torch",
                                  cluster_kernel="torch")
        cpu = partition(gs.src, gs.dst, gs.num_vertices, c, device="cpu")
        card = results[game, "cuda"]
        moved = int((cpu.assign != card.assign).sum())
        log(f"[scale16] game={game} on the CPU: rf {cpu.stats['rf']:.4f} "
            f"against the card's {card.stats['rf']:.4f}; {moved} of "
            f"{gs.num_edges} edges assigned elsewhere; game rounds "
            f"{cpu.game_rounds} and {card.game_rounds}")
        check(moved == 0 and cpu.game_rounds == card.game_rounds,
              f"scale-16 assignment (game={game}) differs between the CPU "
              f"and the card")
    log(f"[scale16] V={gs.num_vertices} E={gs.num_edges}: clustering state, "
        f"game-off and game-on assignments bit-identical (clustering "
        f"{t_kernel:.2f} s kernel, {t_plain:.2f} s plain; game-off rf "
        f"{results[False, 'cuda'].stats['rf']:.4f}; game-on rf "
        f"{on['rf']:.4f}, {on['game_rounds']} rounds, game "
        f"{on['stage_seconds']['game']:.3f} s on the CSR kernel, "
        f"{results[True, 'torch'].stats['stage_seconds']['game']:.3f} s "
        f"dense plain)")
    del gs, ss, sd, a, b, results

    # ------------------------------------------------- phases 5b, 5c, 5d
    t = time.perf_counter()
    sweep_phase(torch, ops, g, main_assign)
    log(f"[sweep] phase {time.perf_counter() - t:.1f} s")
    del main_assign
    t = time.perf_counter()
    rows.append(scan_phase(torch, ops, sm_hz))
    log(f"[scan] phase {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    partition_cli_phase(torch)
    log(f"[partition-cli] phase {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import (init_params, param_count, prefill,
                                    tree_leaves)
    from repro_torch.train import make_prefill_step

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg), "parameter count differs")
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    # a decode step reads every weight but the embedding table (B rows)
    step_bytes = weight_bytes - params["embed"]["table"].numel() * 2
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {n_params} parameters "
        f"({weight_bytes / 1e9:.3f} GB bf16) built in "
        f"{time.perf_counter() - t:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lm_rng = np.random.default_rng(0)
    tokens = torch.from_numpy(lm_rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    prefill_step = make_prefill_step(cfg, dtype=torch.bfloat16)
    prefill_step(params, {"tokens": tokens})        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    logits = prefill_step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    lm_launches = ops.launch_counts()
    log(f"[prefill] launches {json.dumps(lm_launches)}")
    check_path_launches(ops, lm_launches, "lm")
    check(lm_launches["flash_attention"] == cfg.n_layers,
          f"K4 launched {lm_launches['flash_attention']} times, not once "
          "per layer")
    check(logits.shape == (PREFILL_B, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    log(f"[prefill] B={PREFILL_B} S={PREFILL_S}: {t_prefill * 1e3:.3f} ms, "
        f"{PREFILL_B * PREFILL_S / t_prefill:.1f} tokens/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    prompt = torch.from_numpy(lm_rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    generate(params, cfg, prompt[:, :2], 2, dtype=torch.bfloat16)  # warm-up
    ops.reset_launch_counts()
    served = generate(params, cfg, prompt, SERVE_TOKENS, dtype=torch.bfloat16)
    check(not any(ops.launch_counts().values()), "decode launched a kernel")
    check(served.finite and served.tokens.shape == (SERVE_B, SERVE_TOKENS)
          and int(served.tokens.max()) < cfg.vocab, "decode output")
    ms_step = served.seconds * 1e3 / served.steps
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    witness = lm_mesh_witness(torch, cfg, params, tokens, prompt)
    log(f"[serve] B={SERVE_B}, prompt {SERVE_PROMPT} + {SERVE_TOKENS} tokens: "
        f"{served.steps} steps in {served.seconds:.3f} s = {ms_step:.3f} "
        f"ms/token-step (floor: {step_bytes / 1e9:.3f} GB of weights per "
        f"step at 3.35 TB/s = {floor_ms:.3f} ms); first tokens "
        f"{served.tokens[0][:16].tolist()}")
    del params, logits, served
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 7
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(lm_rng.integers(
        0, cfg.vocab, (CHECK_B, CHECK_PROMPT))).to(dev)
    ops.reset_launch_counts()
    pre, _ = prefill(p32, {"tokens": prompt}, small, dtype=torch.float32)
    check(ops.launch_counts().get("flash_attention") == CHECK_LAYERS,
          "the f32 prefill did not run on K4")
    dec = generate(p32, small, prompt, 1, dtype=torch.float32)
    torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                               atol=2e-3)
    log(f"[check] {CHECK_LAYERS} layers at full width, f32, B={CHECK_B}, "
        f"prompt {CHECK_PROMPT}: prefill (K4) vs decode loop last logits "
        f"max |d| {float((dec.prompt_logits - pre[:, -1]).abs().max()):.3e} "
        f"(tolerance 2e-3)")
    del p32, pre, dec
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 8
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(2)

    def qkv(B, S, dtype):
        return [torch.randn(B, h, S, D, generator=gen, device=dev,
                            dtype=dtype) for h in (Hq, Hkv, Hkv)]

    q, k, v = qkv(PREFILL_B, PREFILL_S, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    k4_err = float((got.float() - want.float()).abs().max())
    ms = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                  20)
    plain = event_ms(torch, lambda: ops.flash_attention_plain(
        q, k, v, causal=True), 3, warmup=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    torch.testing.assert_close(sdpa().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    lib = event_ms(torch, sdpa, 20)
    pairs = PREFILL_S * (PREFILL_S + 1) // 2        # unmasked (q, k) pairs
    flops = 4 * D * pairs * PREFILL_B * Hq
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())    # q, o, k, v in bf16
    bms, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:70",
                     launches=lm_launches["flash_attention"],
                     max_abs_err=k4_err, ms=ms, plain_ms=plain, bound_ms=bms,
                     bound_by=by, library_ms=lib))
    log(f"[K4] bf16 q {tuple(q.shape)} k/v {tuple(k.shape)} causal: max |d| "
        f"{k4_err:.3e}; {ms:.4f} ms/launch = {flops / ms / 1e9:.1f} "
        f"TFLOP/s; bound {bms:.4f} ms ({by}); plain {plain:.3f} ms; "
        f"scaled_dot_product_attention {lib:.4f} ms; {cfg.n_layers} launches "
        f"= {cfg.n_layers * ms / (t_prefill * 1e3):.1%} of the prefill")
    # the same shape without the causal mask: twice the work, no diagonal
    # tiles and every q tile the same length
    full_ms = event_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                          causal=False), 20)
    full_lib = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True), 20)
    full_flops = 4 * D * PREFILL_S * PREFILL_S * PREFILL_B * Hq
    log(f"[K4] bf16 same shape, not causal: {full_ms:.4f} ms/launch = "
        f"{full_flops / full_ms / 1e9:.1f} TFLOP/s; "
        f"scaled_dot_product_attention {full_lib:.4f} ms = "
        f"{full_flops / full_lib / 1e9:.1f} TFLOP/s")
    del q, k, v, got, want
    q, k, v = qkv(CHECK_B, F32_S, torch.float32)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    ms32 = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                    20)
    log(f"[K4] f32 q {tuple(q.shape)} k/v {tuple(k.shape)} causal: max |d| "
        f"{float((got - want).abs().max()):.3e}; {ms32:.4f} ms/launch")
    del q, k, v, got, want
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 8a
    lm_mesh_phase(torch, ops, dev, witness, rows[-1])
    del witness
    pp_phase(torch, ops, dev, rows[-1])
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 8b
    moe_phase(torch, ops, dev, rows[-1])
    moe_mesh_phase(torch, ops, dev, rows[-1])

    # ---------------------------------------------------------- phase 8c
    rows.append(mla_phase(torch, ops, dev))

    # ---------------------------------------------------------- phase 8d
    ssm_phase(torch, ops, dev, next(r for r in rows
                                    if r["name"] == "flash_attention"))

    # ---------------------------------------------------------- phase 8e
    rows.append(encdec_phase(torch, ops, dev))

    # ---------------------------------------------------------- phase 8f
    rows.append(vlm_phase(torch, ops, dev))

    # ---------------------------------------------------------- phase 8f'
    family_mesh_phase(torch, ops, dev, rows)

    # ---------------------------------------------------------- phase 8g
    train = train_phase(torch, ops, dev)
    k4_row = next(r for r in rows if r["name"] == "flash_attention")
    k4_row["launches"] += train["launches"]
    k4_row["train_shapes"] = train["shapes"]
    # K4's backward at [train]'s shape: its launches are [train]'s and
    # [train-mesh]'s; the plain version is the tensor code it replaced, the
    # library call scaled_dot_product_attention's backward
    rec = train["shapes"][0]
    rows.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="no TPU kernel: src/repro/kernels/flash_attention.py:70 has "
                 "no backward; the reference takes autodiff of "
                 "chunked_attention, src/repro/models/attention.py:62",
        launches=train["bwd_launches"], max_abs_err=rec["twin"]["max_abs"],
        ms=rec["bwd_ms"], plain_ms=rec["tensor_code_bwd_ms"],
        bound_ms=rec["bwd_bound_ms"], bound_by=rec["bwd_bound_by"],
        library_ms=rec["sdpa_bwd_ms"], train_shapes=[
            {k: r[k] for k in ("q_shape", "kv_shape", "bwd_ms",
                               "bwd_bound_ms", "tensor_code_bwd_ms",
                               "sdpa_bwd_ms", "fwd_bwd_ms", "sdpa_fwd_bwd_ms",
                               "twin")} for r in train["shapes"]],
        train_step_share=train["bwd_step_share"]))

    # ---------------------------------------------------------- phase 8g'
    train_families_phase(torch, ops, dev, rows)

    # ---------------------------------------------------------- phase 8h
    train_mesh_phase(torch, ops, dev, train, k4_row, rows[-1])

    # ---------------------------------------------------------- phase 9
    log(f"[profiler] timings read by CUDA events where no profiler session "
        f"was whole: {PROFILER_FALLBACKS or 'none'}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
