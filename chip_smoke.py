#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (at first
use, into ``build/repro_torch/``) and runs these phases, each printing
one JSON line:

1. ``device``  — the card's name and power limit (nvidia-smi);
2. ``build``   — compile and load the kernel library, with its seconds;
   then a second ``device`` line: the card's SM count and how many
   clusters of 1-8 CTAs it holds at once at the wide bodies' shared
   memory (the paged prefill's, the ring form's and the decode's),
   against the constants the split rules read (``SM_COUNT`` of four
   kernel modules, ``WIDE_CLUSTERS``; for the ``wgmma`` bodies of the
   cross form, the paged chunk and the window form at hd 64 and 128,
   the occupancy calculator on each kernel itself), and the CTAs an SM
   holds of the contiguous, cross, paged-chunk and window forms'
   ``wgmma`` bodies at their dynamic shared memory (the occupancy
   calculator on each kernel) against ``WGMMA_CTAS_PER_SM``, their
   shared memory and key tiles against the Python mirrors: a mismatch
   fails by name before any kernel phase.  The build line also prints
   ptxas's report of the twenty-three ``wgmma`` entries (``WGMMA_ENTRIES``:
   registers at launch, spills) and fails if one is missing or spills; then ``planning`` (host only, numpy): the paper's simulation
   study, the four strategies (Algorithm 1's ``proposal``, ``prop_avg``,
   ``lbrr``, ``ga``) on ``baseline`` over seeds 0-2 at the default
   horizon of 100 slots, a line of on-time share, completed share, total
   cost and wall seconds a trial and the grid's summary by strategy, and
   the scalar engine held to the vectorised ``Simulator`` trial for
   trial (lbrr and ga at 100 slots, proposal and prop_avg at 30);
3. ``kernels`` — every kernel against its plain PyTorch version on the
   card at the main path's shapes, in float32 (tolerance 2e-5; 1e-4 for
   the quant matmuls, whose sums over K up to 2560 run in another order;
   2e-5 of max(1, |plain|) for the selective scan, whose outputs reach
   tens, in float32 only, the dtype the model feeds it) and bfloat16
   (2e-2, and every element within two bf16 rounding steps of its own
   value: both sides compute in f32 and round once), with the kernel's,
   the plain version's and one PyTorch library call's device time
   (torch.profiler; no single PyTorch call computes the scan's
   recurrence, so it has none), the kernel's time per back-to-back call
   (CUDA events, launch cost included), and the least time the card
   could take.  For the three kernels with a tensor-core body besides
   their CUDA-core one (paged prefill, paged and dense decode) the
   bf16 cases also time the previous CUDA-core body on the same inputs,
   in turns with the new one (new, old, old, new), as ``prev_ms``, and
   gate its output too; the int8 and int4 quant matmul (``qmm_case``)
   time their rule's body against the other tensor-core body so
   (``wgmma`` against ``mma``; ``mma`` against ``wgmma`` for int8 at
   smollm-360m's sites), each also bit-equal over repeated launches, and beside ``torch.matmul`` on
   the dense weight the weight-only call (``torch._weight_int8pack_mm``,
   ``torch._weight_int4pack_mm``; gated against the plain version within
   ``QMM_LIB_TOL`` first, or its refusal in ``library_note``), and at
   smollm-360m's shapes the kernel, the other body and ``torch.matmul`` with
   their weights cold in L2 (``cold_ms``: a distinct copy a launch over
   100 MB); so do the selective scan's cases for its
   previous body (``cuda_core``, against ``state_lanes``), whose
   ``h_T`` must also equal the new body's bit for bit, and which print
   the scan's instruction-issue bound beside the bytes bound.  rmsnorm
   runs on its ``norm`` body (against ``F.rms_norm``; bf16 also against
   its previous ``cuda_core`` body) and fused with the residual add on
   its ``add_norm`` body, whose ``r`` must equal torch's ``x + delta``
   bit for bit and whose ``out`` is gated like any output; the fused
   case's previous composition (torch's add, then the ``cuda_core``
   norm) is its ``prev_ms``, and torch's add then ``F.rms_norm`` its
   ``library_pair_ms`` (no single PyTorch call computes it, so its
   ``library_ms`` is null).  rmsnorm is also checked and timed at the
   train step's 32768 rows of 960 and at the widths of falcon-mamba-7b
   and gemma3-12b (8 and 128 rows of 4096 and of 3840, bf16).  The batched paged-chunk form
   of the flash kernel (``paged_chunk_attention``, a verify round's B 8
   rows of C = K + 1 = 5 tokens, each row's pos read on the device) must
   also give each row the bits of a one-row call at its pos, and the
   same bits in blocks of 32 as in blocks of 16; its library call is
   ``F.scaled_dot_product_attention`` over the gathered KV with a per-row
   mask.  The window form of the flash kernel
   (``ring_chunk_attention``: C 128 queries of gemma3-12b's 16 heads of
   256 over a ring of w = 1024 slots plus the chunk's own keys) runs at
   pos 0, 512 and 3000 in float32 (``cuda_core``) and bfloat16 (``mma``,
   timed in turns against ``cuda_core``), must give the same bits in
   blocks of 32 and as a dense one-block ring as in blocks of 16, and
   with pos read on the device as with a host int, and prints both
   halves of its bound; its library call is
   ``F.scaled_dot_product_attention`` over ``[gathered ring ; chunk]``
   with the boolean window mask.  The attention kernels also run at
   gemma3's hd 256: the one-row prefill (C 128 at pos 1024 and 2048)
   and both decode kernels (B 8, pos 5-2000, over linear rows and over
   rings) in bfloat16 on their wide ``mma`` bodies, timed in turns
   against ``cuda_core``, the prefill's bits the same in blocks of 16,
   32 and one dense block and the dense decode's the paged decode's on
   the same rows; and in float32 on ``cuda_core`` (prefill at pos 1024,
   decode over linear rows).  At mixtral-8x7b's attention (32 heads over
   8 of 128, a ring of 4096 slots) the window form (C 128 at pos 0, 2048
   and 4300; bf16 on its ``wgmma`` body, the ``mma`` body in turns, its
   bits the same in blocks of 32, as a dense ring and at a device pos)
   and both decode kernels over rings (B 8, pos 5-4470, clamped to
   w - 1; the dense kernel's bits the paged one's; ``mma``) run beside
   plain, SDPA and the bound, and so do the paged prefill (C 128 at pos
   0, 1024 and 2048; ``wgmma`` on the hd-128 body, ``mma`` in turns, its
   bits the same in blocks of 32, one dense block and a batched launch
   at a device pos) and both decode kernels (B 8 over linear rows of
   2176 slots, pos 5-2175; the dense kernel's bits the paged one's) at
   zamba2-7b's weight-shared attn block (32 heads over 32 KV heads of
   112, G 1).  The flash kernel's
   cross form (``paged_cross_attention``: C 128 queries over every one of
   src source slots, unmasked) runs at seamless-m4t-medium's enc_xattn
   (16 / 16 heads of 64, src 1024) and llama-3.2-vision-90b's xattn (64 /
   8 heads of 128, src 1601), B 1 through shuffled cross tables and B 8
   through identity tables over dense rows (bit-equal to the paged
   read), bf16 on ``wgmma`` (the previous ``mma`` body gated and timed
   in turns) and f32 on ``cuda_core``, beside plain, SDPA and both
   halves of the bound; so do both decode kernels at those
   cross shapes (B 8, pos src - 1; the dense kernel's bits the paged
   one's) and the paged prefill at llama-3.2-vision-90b's attn layers
   (hd 128, G 8; C 128 at pos 0 and 1024; ``wgmma``, ``mma`` in turns,
   the same bit checks).  The selective scan
   also runs at zamba2-7b's d_state 64 (a decode step of 8 rows and a
   chunk of 128 over d_inner 7168, B and C the halves of ``bc_proj``'s
   output), state_lanes against cuda_core as at d_state 16.  The
   contiguous form of the flash kernel (``flash_attention``, the TPU
   kernel's own signature, the train
   path's) runs at smollm-360m's train shape (B 8, S 4096, 15 / 5 heads
   of 64, causal, bf16 on ``wgmma``, timed in turns against ``mma``, which
   is gated too), the same heads at S 1024 in float32 (``cuda_core``),
   gemma3-12b's heads with its 1024 window (bf16 on ``mma``, the wide
   tiles), seamless-m4t-medium's encoder in ``Model.prefill`` (B 8, S
   1024, 16 / 16 heads of 64, non-causal, ``wgmma`` against ``mma`` in
   turns), ``Model.prefill``'s decoder self-attention over 8 prompts of
   128 (hd 64 on ``wgmma``; llama-3.2-vision-90b's hd 128, G 8 on
   ``wgmma`` too), a long row at hd 128 (B 1, S 4096, 32 / 8 heads,
   causal; ``wgmma`` against ``mma`` in turns), zamba2-7b's train shape
   (B 2, S 2048, 32 / 32 heads of 112, causal; ``wgmma`` on the hd-128
   body against ``mma`` in turns), and a non-causal ragged
   case (B 2, S 1000, with a window it
   must ignore) in both dtypes (bf16 on ``wgmma`` against ``mma`` in
   turns; on ``wgmma`` the model's ``(B, S, heads, hd)`` layout, passed
   as transposed views, must give the contiguous run's bits), its row
   log-sum-exp within 2e-5 / 1e-2 (``mma``'s too),
   beside ``F.scaled_dot_product_attention`` (``enable_gqa``;
   causal, or the boolean window mask), and the torch-op gradient of one
   layer timed at the train shape; ``FlashAttentionFn``'s dq / dk / dv
   (B 2, S 512) and the norms' gradients and their Functions' forward
   (8 and 128 rows of 960, and in bf16 the train step's 32768) are held
   to autograd through the plain versions.  An empty kernel
   (``csrc/launch_floor.cu``; not a port of any TPU kernel, so not in
   the kernel list) gives the floor one launch costs, at 1 block and at
   the decode scan's grid.  The speculation targets' new shapes run in
   bf16 too: the batched chunk form at qwen2-72b's verify round (B 8,
   C 5, 64 / 8 heads of 128, pos 32-600) and the int8 / int4 quant
   matmul at qwen2-72b's MLP at decode (8 x 8192 -> 29568 and 8 x 29568
   -> 8192) and at a prefill chunk (128 rows), weights drawn on the
   card.  Training's scan kernels in
   float32: falcon-mamba-7b's serving launches (8 x 1 and 1 x 128 over
   8192 channels) with the checkpoint pointer give the bits of the
   launches without it; at the train runs' shapes (B 2, T 2048:
   falcon-mamba-7b's 8192 channels of d_state 16, zamba2-7b's 7168 of
   64 with Mamba2's A) the forward is timed with and without
   checkpoints in turns, and the backward kernel
   (``selective_scan_backward``) from those checkpoints is held to its
   plain version (2e-5 of max(1, |plain|)), launched twice with the
   same bits, timed beside the plain version and its bound;
   ``CrossAttentionFn``'s forward equals the cross form over identity
   tables bit for bit at the cross train runs' reads (one ``wgmma``
   launch), its torch-op backward timed beside it;
4. ``parity``  — smollm-360m at full width, 2 layers, float32: one trace
   through the paged engine (unquantized, int8, int4) and the slot
   engine ``ServingEngine`` (unquantized, int8) on the card (kernels)
   and on the CPU (plain versions), and with ``speculative=4``: n-gram
   drafts through the paged engine (unquantized and int8) and the slot
   engine, and a model draft (2-layer smollm-360m on its own seed)
   through the paged engine; then falcon-mamba-7b and gemma3-12b (one
   ``swa`` layer with the published window of 1024, one ``attn``; 2
   prompts of 1040-1200 tokens, so every ring wraps, 8 new tokens each)
   at full width, 2
   layers, float32, through the paged and the slot engine, and with
   ``speculative=4``, which both must gate off.  The pipelined engines
   (``PagedPipelinedEngine`` and ``PipelinedEngine``, 2 stages) run the
   same traces for all three models, and for smollm-360m with int8
   weights and with ``speculative=4`` too.  Each pair of streams and
   ``t_*`` stamps must be equal, on the card the slot engine's streams
   must equal the paged engine's, each speculative stream the same
   engine's and format's non-speculative one, and each pipelined run's
   streams and stamps the monolithic engine's.  Last, the overload trace
   of tests/test_paged.py (two batch hogs ahead of four interactive
   requests) through smollm's paged engine under FIFO, ``edf`` and
   ``edf_ec``: streams, stamps, goodput, per-class stats and rejections
   equal the CPU's, and every policy's streams FIFO's.  Then
   mixtral-8x7b at full width (d_model 4096, 32/8 heads of 128, 8
   experts, top-2), 2 layers, float32, each expert's d_ff cut to 1024
   and the window to 256: 3 prompts of 300-400 tokens (the ring wraps), 8
   new tokens each, through the paged engine (unquantized, int8), the
   slot engine and the paged pipeline, held as above; and the
   capacity-pressure trace of tests/test_paged.py (12 rows, staggered
   budgets) through the slot engine at K 8 and K 1: card = CPU at each
   K, K 8 = K 1 on each side, and some claim of a decode step dropped.
   Last, zamba2-7b at full width (d_model 3584, d_inner 7168, d_state
   64, 32 heads of 112) cut to 4 layers, float32: Mamba2, the shared
   attn block, Mamba2, the shared attn block again; 4 prompts of 20-64
   tokens, 8 new tokens each, through the paged engine (unquantized,
   int8), the slot engine and the paged pipeline, whose boundary falls
   between the two shared positions, held as above.  Then the
   cross-attention families at full width, float32, 2 decoder layers:
   seamless-m4t-medium (2 of its encoder layers) through the paged engine
   (unquantized, int8), the slot engine and the paged pipeline, and
   llama-3.2-vision-90b (one ``attn`` and one ``cross`` layer, d_ff cut
   to 4096) through the paged and the slot engine, 4 prompts of 20-48
   tokens, 8 new tokens each, held as above (requests carry no frontend:
   the cross K/V are zeroed at admission, as in the reference); then for
   each ``Model.prefill`` of 2 prompts of 32 tokens with a seeded
   frontend and 8 tokens of ``decode_steps`` over the prefilled caches,
   whose cross K/V are real: the streams card = CPU.  Last, qwen2-72b
   and command-r-35b at smoke size (2 layers of 128, vocab 512), float32,
   4 prompts of 20-40 tokens, 16 new tokens each, through both engines
   with no draft, n-gram drafts and the smoke smollm-360m as a model
   draft (K 4): card = CPU, and every speculative stream the engine's
   plain one;
5. ``serve``   — smollm-360m at full width and depth in bfloat16 with
   random weights from a seed: 16 requests through
   ``PagedServingEngine``, then 8 of them through ``ServingEngine`` and
   through ``PagedServingEngine`` with int8 and with int4 weights; every
   request must finish with 64 in-vocab tokens and every kernel must
   have been launched the number of times each run's shapes imply (the
   counts are reset before and read after each run), every launch
   of the six two-body kernels must have taken its tensor-core body
   (all serve runs are bf16), the quant matmul's must split between
   ``wgmma`` and ``mma`` as its rule names them at the rows of each
   forward (``quant_bodies``: smollm-360m's int4 attention projections
   take ``mma`` at a 128-row chunk), and rmsnorm's launches must split
   between its ``add_norm`` and ``norm`` bodies as the run implies; each
   quantized or
   slot run prints the share of its tokens equal to the bf16 paged
   run's on the same requests (not gated: random 32-layer weights);
   the last run repeats the bf16 paged engine on the same 8 requests.
   Then ``speculative=4`` (n-gram drafts) through the paged and the slot
   engine on those 8 requests (``paged_spec``, ``dense_spec``): rounds,
   acceptance, host syncs per token, the share of tokens equal to the
   repeated bf16 paged run's (not gated), and exactly one batched chunk
   attention a layer a round, every launch on ``wgmma``.
   Then the paper's static tier: ``pipe_paged_bf16``
   (``PagedPipelinedEngine``) and ``pipe_dense_bf16``
   (``PipelinedEngine``), smollm-360m in 2 core stages over a seeded
   edge network (``make_network``), on the same 8 requests: each stage's
   decode step is timed by CUDA events (``profile``), the executed
   pipeline becomes the paper's application (``to_application``), the
   integer program places its stages (``place_stages(..., "static_ip")``)
   and the engine serves on that placement; each must emit
   ``paged_bf16_8``'s / ``dense_bf16``'s tokens with the same launches by
   kernel and body and a peak memory within 5% of theirs, and prints its
   stage times, placement, simulated transfer a token, tok/s, peak
   memory and launches beside them.  Then the online tier:
   ``fifo_paged`` and ``edf_ec_paged``, the 16 requests with QoS classes
   round-robin in a pool of 96 blocks, printing goodput, per-class
   stats, rejections and preemptions, and for requests finished under
   both the share of tokens equal to ``paged_bf16``'s (not gated).
   Then falcon-mamba-7b at full width and ``MAMBA_LAYERS`` = 32 of its
   64 Mamba1 layers (halved, as gemma3's, mixtral's, zamba2's and
   vision's depths were, to make room for the scale phase) in
   bfloat16: 8 requests through ``PagedServingEngine`` and the same 8
   through ``ServingEngine``, with the same checks (the slot run's share
   of tokens equal to the paged run's printed, and every scan launch on
   the ``state_lanes`` body).
   Then gemma3-12b at full width and ``GEMMA_LAYERS`` = 12 of its 48
   layers (10 ``swa`` with the 1024-slot ring, 2 ``attn``) in bfloat16,
   about 7.3 GB of weights drawn on the card: 8 requests of 256-2048
   tokens (six past the window), 64 new tokens each, through
   ``PagedServingEngine`` (``gemma_paged_bf16``, profiled in decode and
   prefill, with prompts past the window) and ``ServingEngine``
   (``gemma_dense_bf16``, its share of tokens equal to the paged run's
   printed); a prefill chunk launches the ring form 10 times and the
   paged prefill 2 times, a decode iteration the decode kernel 12
   times, checked exactly: the
   paged prefill, the ring form and the decode on the wide ``mma``
   bodies (hd 256).  Which body each attention kernel's launches take is
   fixed per config in ``ATTN_BODY`` (``mma`` for all five two-body
   attention kernels of gemma3-12b; at hd 64, 112 and 128 the paged
   chunk, the batched chunk and the window form on ``wgmma``, the
   decodes on ``mma``), and the wrappers' rules must agree with it.
   Then mixtral-8x7b at full width and ``MIXTRAL_LAYERS`` = 4 of its 32
   layers (32 would need about 93 GB of bf16 weights; the experts are
   never packed) in bfloat16, about 12 GB drawn on the card: 8 requests
   (6 of 256-2048
   tokens, 2 of 4160-4400, past the 4096 window), 64 new tokens each,
   through ``PagedServingEngine`` (``mixtral_paged_bf16``, profiled in
   decode and prefill) and ``ServingEngine`` (``mixtral_dense_bf16``),
   launches by kernel and body checked exactly (the experts launch no
   port kernel); the share of claims dropped in the paged run's first
   decode step, first full chunk and over the run is printed, not
   gated; then ``moe_apply`` at full width at a decode step's and a
   chunk's shape under ``torch.cuda.set_sync_debug_mode("error")``.
   Then zamba2-7b at full width and ``ZAMBA_LAYERS`` = 21 of its 81
   layers (18 Mamba2 and 3 positions of one weight-shared attn block)
   in bfloat16, about 3.6 GB of weights drawn on the card: 8 requests of
   256-2048 tokens, 64 new tokens each, through ``PagedServingEngine``
   (``zamba_paged_bf16``, profiled in decode and prefill) and
   ``ServingEngine`` (``zamba_dense_bf16``), launches by kernel and body
   checked exactly (a decode iteration: 25 norms, 3 decode attentions
   and 18 scans; a chunk: 24 norms, 3 paged prefills and 18 scans),
   then the paged
   run's requests through ``PagedPipelinedEngine`` in 2 stages
   (``zamba_pipe_paged_bf16``, placed by the static tier), which must
   emit the paged run's tokens and launches at a peak within 5% of its
   memory, every stage on the one shared set, uncopied.
   Then seamless-m4t-medium uncut (12 encoder and 12 decoder layers,
   about 2 GB of bf16 weights): 8 requests of 32-512 tokens through
   ``PagedServingEngine`` (``seamless_paged_bf16``) and
   ``ServingEngine`` (``seamless_dense_bf16``), launches by kernel and
   body checked exactly (a decoder block: three norms, a decode
   attention and a cross decode read an iteration; a paged prefill and
   a cross form a chunk), then ``seamless_prefill_bf16``:
   ``Model.prefill`` of 8 prompts of 128 tokens with a seeded (8, 1024,
   1024) frontend through the encoder, then 4 macro-steps of
   ``decode_steps(k=16)`` on the dense caches (encoder ms, prefill ms,
   decode tok/s; launches checked exactly).  Then llama-3.2-vision-90b at
   full width and 15 of its 100 layers (12 ``attn``, 3 ``cross``; about
   29.9 GB of bf16 weights drawn on the card): 8 requests of 256-1024
   tokens through ``PagedServingEngine`` (``vision_paged_bf16``,
   profiled over one decode macro-step and 4 prefill chunks) and
   ``ServingEngine`` (``vision_dense_bf16``), launches checked exactly,
   then ``vision_prefill_bf16`` as seamless's with an (8, 1601, 8192)
   frontend.  Then the speculation targets at full width, 8 layers,
   bf16 (``serve_targets``): qwen2-72b (about 19 GB drawn on the card)
   through ``PagedServingEngine`` plain (``qwen_paged_bf16``, profiled
   over a decode macro-step), with K 4 and a model draft of
   smollm-360m's widths at qwen2's vocabulary 152064
   (``qwen_spec_bf16``, a verify round profiled; its streams equal the
   plain run's but where the plain path's top two logits nearly tie,
   ``check_spec_streams``) and with int8 and int4 weights
   (``qwen_paged_int8``, ``qwen_paged_int4``, each profiled);
   command-r-35b (``command_r_paged_bf16``, its head the tied
   256000-row table read in place, profiled).  Every serve run prints
   its dispatches by program name (``serving/instrument.py``), which
   must match its macro-steps, verify rounds and prefill chunks, and a
   model draft's decode iterations and prefill chunks join its expected
   launches.
   ``profile`` (after the bf16, int8 and int4 smollm paged runs and the
   falcon-mamba, gemma3, mixtral, zamba2 and vision paged runs; two steady
   verify rounds after ``paged_spec``):
   one steady decode macro-step (``PROFILE_ITERS`` = 8 iterations)
   timed without the profiler, then the same window again under
   torch.profiler for
   the device's busy time, the top kernels and the port's own kernels
   by device time; the idle share is one minus busy over the
   unprofiled wall time.  After the bf16 smollm paged run and the
   falcon-mamba and zamba2 paged runs, the same for a prefill window: 4
   requests of 385 tokens admitted at once, 12 chunks of 128, with the
   device busy time per chunk (mixtral-8x7b: 4 requests of 1153 tokens,
   36 chunks; gemma3: 2 of them, 18 chunks; llama-3.2-vision: 4 of 129
   tokens, 4 chunks).  No window reruns on a previous body: the
   kernels phase times each redesigned kernel against its previous body
   in turns.

6. ``train``  — smollm-360m at full width, 2 layers, float32, on the
   card against the CPU from the same weights: the loss (1e-5 relative)
   at each of two steps of ``make_train_step``'s body, and at the
   first every gradient leaf (1e-5 of max(1, |g|)) and AdamW fed the
   same gradients on both sides (1e-6); then smollm-360m at full
   width and depth in bf16 with f32 AdamW state, 8 steps at B 8, S 4096
   through ``launch/train.py``'s setup, a line a step (ce, grad norm,
   lr, wall ms, tokens/s, peak memory): every ce finite and the last
   below the first, the launches exactly what ``expected_train_launches``
   implies (the flash kernel twice a layer a step, all on ``wgmma``:
   forward and the checkpoint's recompute; 4n + 1 norms), no plain
   version run; then one more step under torch.profiler (busy ms, idle
   share, the flash kernel's, the torch-op backward's and cuBLAS's ms).
   Every other family trains too (``TRAIN_FAMILY_PARITY``, float32, card
   against CPU on card-drawn weights, the cross families with a seeded
   frontend, learning rate ``family_lr``: mixtral-8x7b, falcon-mamba-7b,
   zamba2-7b at four layers, llama-3.2-vision-90b's cross layer,
   seamless-m4t-medium at 2 + 2 layers, each cut as its comment names:
   the same checks), and
   ``TRAIN_RUNS`` at full width in bf16 with f32 AdamW state, 4 steps
   each (mixtral 1 of 32 layers, falcon-mamba 8 of 64, zamba2 four
   layers, vision one attn and one cross layer, seamless uncut), gated
   as train_bf16 is on ``expected_train_launches``' count for every
   family (the scan forward twice and its backward once for each Mamba
   layer, the cross form twice for each cross read), the falcon-mamba
   and vision runs profiled (the scan kernels' ms, the torch-op
   backwards' by label).

7. ``scale``  — the scale-out plane (``serving/decode.py``, the sharded
   MoE forms, ``sharding/specs.py``): ``SCALE_WORLD`` = 4 ranks spawned
   once (spawn: this process holds a CUDA context) as 4 processes on
   cuda:0 over gloo (NCCL places no two ranks on one card; gloo
   all-reduces CUDA tensors), rendezvous through a FileStore in a
   temporary directory, the kernel library built here first so the
   ranks only load it; one world carries a 2x2 and a 1x4 ``("data",
   "model")`` mesh.  Each rank: the f32 cell (every form at the CPU
   tests' widths on the card and on CPU tensors through the same
   groups, card = CPU within 1e-5, drops exactly); the seq-parallel
   decode at decode_32k's S 32768, B 8 (smollm-360m's 15/5 heads of 64
   on the 2x2 mesh in f32 and bf16, rows that leave a model shard
   empty; qwen2-72b's 64/8 of 128 on the 1x4 mesh in bf16), its output
   gated against one-rank ``dense_decode_attention`` over the whole
   cache and against the plain version (2e-5 f32; 2e-2 and two bf16
   steps), its partials against the plain partials; the main path's
   launches (every count reset just before the three distributed
   calls, read just after): the partials form once a call, f32 on
   ``cuda_core``, bf16 on ``mma``, no other kernel; the partials kernel
   timed on rank 0 in turns with its library call and its plain
   version, the combine's three all-reduces on every rank (printed, not
   gated); then kimi-k2-1t-a32b's MoE layer at full width through
   ``moe_apply_sharded`` on the 1x4 mesh, each rank drawing and holding
   only its 96 of 384 experts (8.46 GB), and mixtral-8x7b's through
   ``moe_apply_capsharded``, 1024 tokens each, each rank's local part
   under ``set_sync_debug_mode("error")``, nvidia-smi's memory while
   every rank holds its experts; each rank's peak memory.  After the
   ranks exit, the single-process ``moe_apply`` over all the experts
   (kimi-k2's 33.8 GB) on the same tokens: y within 2e-2 and two bf16
   steps of every rank's, the drop fraction exactly.  Then ``python -m
   repro_torch.launch.serve`` at its defaults on the card: exit 0, every
   request done.

8. ``dryrun`` — the dry-run (``launch/dryrun.py``: one rank's
   partitioned step as DTensors over a fake process group, fake tensors,
   no memory used) in spawned worker processes
   (the fake group never meets the scale phase's gloo ranks), one line a
   cell of ``DRYRUN_CELLS``: smollm-360m prefill_32k / decode_32k on
   16x16, mixtral-8x7b decode_32k on 2x16x16, falcon-mamba-7b
   long_500k, and smollm-360m long_500k, which the reference's rule
   skips (the train_4k cells of kimi-k2-1t-a32b and smollm-360m, the
   costliest, run in the full sweep only).  Gates: each status as
   listed, flops > 0 where it ran, and every collective kind torch's
   ``CommDebugMode`` saw the cell's DTensors issue counted as often by
   the dry-run's recorder.  Then one line, not gated: the dry-run's
   peak bytes and flops of smollm-360m's train step on a 1x1 mesh at
   the train phase's B 8, S 4096, beside that phase's measured peak and
   a ``FlopCounterMode`` count of one of its real steps.

Each phase ends with a line of its wall seconds, as each serve run's and
each profile's line carries its own.  It then prints the kernel list,
the card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failure raises
and the exit code is non-zero.  Without a CUDA device it exits with
code 2 before printing anything.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-5   # two bf16 rounding steps
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, 80 GB HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no sparsity
QMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # f32 sums over K <= 2560
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:20",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:158",
    "paged_prefill_attention": "src/repro/kernels/flash_attention.py:72",
    "paged_chunk_attention": "src/repro/kernels/flash_attention.py:72",
    "paged_cross_attention": "src/repro/kernels/flash_attention.py:72",
    "ring_chunk_attention": "src/repro/kernels/flash_attention.py:72",
    "dense_decode_attention": "src/repro/kernels/decode_attention.py:76",
    "quant_matmul_int8": "src/repro/kernels/quant_matmul.py:54",
    "quant_matmul_int4": "src/repro/kernels/quant_matmul.py:54",
    "selective_scan": "src/repro/kernels/selective_scan.py:61",
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
    # no TPU kernel: jax.grad of mamba1_seq's lax.scan (mamba2_seq's at
    # :214), which the reference's train step differentiates
    "selective_scan_backward": "src/repro/models/ssm.py:115",
    # the partials form: _local_flash_decode
    # (src/repro/serving/decode.py:26), whose on-device body is this TPU
    # kernel
    "dense_decode_attention_partial": "src/repro/kernels/decode_attention.py:76",
}
#: the file of a body that lives apart from its kernel's entry points
BODY_SOURCES = {**{(k, "wgmma"): "src/repro_torch/csrc/chunk_wgmma.cu"
                   for k in ("paged_prefill_attention",
                             "paged_chunk_attention",
                             "ring_chunk_attention")},
                **{(k, "wgmma"): "src/repro_torch/csrc/quant_wgmma.cu"
                   for k in ("quant_matmul_int8", "quant_matmul_int4")}}
SOURCES = {
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_decode_attention.cu",
    "paged_prefill_attention": "src/repro_torch/csrc/paged_prefill_attention.cu",
    "paged_chunk_attention": "src/repro_torch/csrc/paged_prefill_attention.cu",
    "paged_cross_attention": "src/repro_torch/csrc/paged_cross_attention.cu",
    "ring_chunk_attention": "src/repro_torch/csrc/ring_chunk_attention.cu",
    "dense_decode_attention": "src/repro_torch/csrc/dense_decode_attention.cu",
    "quant_matmul_int8": "src/repro_torch/csrc/quant_matmul.cu",
    "quant_matmul_int4": "src/repro_torch/csrc/quant_matmul.cu",
    "selective_scan": "src/repro_torch/csrc/selective_scan.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "selective_scan_backward": "src/repro_torch/csrc/selective_scan.cu",
    "dense_decode_attention_partial":
        "src/repro_torch/csrc/dense_decode_attention.cu",
}
#: the serve run whose launches each kernel's line reports
LAUNCH_RUN = {"rmsnorm": "paged_bf16", "paged_decode_attention": "paged_bf16",
              "paged_prefill_attention": "paged_bf16",
              "paged_chunk_attention": "paged_spec",
              "paged_cross_attention": "vision_paged_bf16",
              "ring_chunk_attention": "gemma_paged_bf16",
              "dense_decode_attention": "dense_bf16",
              "quant_matmul_int8": "paged_int8",
              "quant_matmul_int4": "paged_int4",
              "selective_scan": "mamba_paged_bf16",
              "flash_attention": "train_bf16",
              "selective_scan_backward": "mamba_train_bf16",
              "dense_decode_attention_partial": "scale"}
#: the dtype of each kernel's main-path case in the kernels line
MAIN_DTYPE = {"selective_scan": "float32",
              "selective_scan_backward": "float32"}
#: the bodies every serve-run launch of a kernel with more than one body
#: must take (rmsnorm: split as expected_launches says; the attention
#: kernels as ``ATTN_BODY`` names them for the run's config)
MAIN_BODY = {"selective_scan": ("state_lanes",),
             "rmsnorm": ("add_norm", "norm")}   # the others: ("mma",)
#: the bodies the bf16 quant launches of the configs served packed in
#: bf16 take, over their projection sites at a decode row and a full
#: chunk (``main_bodies`` checks that the rules agree; ``quant_bodies``
#: counts a run's launches by body): smollm-360m's int8 sites keep mma
#: (their weights are below ``WGMMA_INT8_MIN_BYTES``), and so do its
#: int4 attention projections at a 128-row chunk (below
#: ``WGMMA_INT4_CHUNK_MIN``); every other on wgmma
QUANT_BODY = {"smollm-360m": {"quant_matmul_int8": ("mma",),
                              "quant_matmul_int4": ("mma", "wgmma")},
              "qwen2-72b": {"quant_matmul_int8": ("wgmma",),
                            "quant_matmul_int4": ("wgmma",)}}
#: rows of x the quant rules are read at by ``main_bodies``: a decode
#: row and a full prefill chunk (the serve runs' chunks are 128 rows)
QUANT_ROWS = (1, 128)
#: the rule that names each two-body attention kernel's body
ATTN_RULE = {"paged_prefill_attention": "chunk_body",
             "paged_chunk_attention": "chunk_body",
             "paged_cross_attention": "cross_body",
             "ring_chunk_attention": "ring_body",
             "paged_decode_attention": "decode_body",
             "dense_decode_attention": "decode_body"}
#: the body of every launch of each attention kernel, per served config,
#: fixed here (a config not named takes mma everywhere): the paged chunk
#: (one-row and batched) and the window form take their wgmma body
#: (``csrc/chunk_wgmma.cu``) at hd 64, 112 and 128, every served
#: config but gemma3-12b, whose hd 256 takes the wide mma bodies of the
#: paged prefill, the batched chunk, the ring form and both decodes; the
#: cross reads of seamless-m4t-medium (hd 64) and llama-3.2-vision-90b (hd
#: 128) take the cross form's wgmma body.  ``main_bodies`` checks that the
#: wrappers' rules agree.
CHUNK_WGMMA = {"paged_prefill_attention": "wgmma",
               "paged_chunk_attention": "wgmma",
               "ring_chunk_attention": "wgmma"}
ATTN_BODY = {"gemma3-12b": {"paged_prefill_attention": "mma",
                            "paged_chunk_attention": "mma",
                            "ring_chunk_attention": "mma",
                            "paged_decode_attention": "mma",
                            "dense_decode_attention": "mma"},
             "smollm-360m": CHUNK_WGMMA,
             "mixtral-8x7b": CHUNK_WGMMA,
             "zamba2-7b": CHUNK_WGMMA,
             "seamless-m4t-medium": {**CHUNK_WGMMA,
                                     "paged_cross_attention": "wgmma"},
             "llama-3.2-vision-90b": {**CHUNK_WGMMA,
                                      "paged_cross_attention": "wgmma"},
             "qwen2-72b": {**CHUNK_WGMMA,
                           "paged_decode_attention": "mma",
                           "dense_decode_attention": "mma"},
             "command-r-35b": {**CHUNK_WGMMA,
                               "paged_decode_attention": "mma",
                               "dense_decode_attention": "mma"}}
#: the body of every contiguous flash launch of a ``Model.prefill`` in
#: bf16 (seamless-m4t-medium's hd 64, llama-3.2-vision-90b's hd 128)
PREFILL_FLASH_BODY = "wgmma"
#: the scan's issue bound: the thread instructions one state update
#: takes as the card compiles it (cuobjdump of csrc/selective_scan.cu:
#: dt*a, the accurate expf's eight, decay*h, dx*B, their sum, h*C and
#: its add to y), with no loads, over the card's issue rate (132 SMs x 4
#: schedulers x one 32-thread instruction a clock at the H100 SXM's
#: 1.98 GHz boost clock)
SCAN_INSTR_PER_UPDATE = 14
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def call_ms(fn, n: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``n`` back-to-back calls (CUDA
    events): the device time, or the host's launch time when that is
    longer, as it is for kernels of a few microseconds."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20, warmup: int = 3, attempts: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the
    kernels it launches, from torch.profiler, over ``n`` calls (inputs
    warm in L2).  Host launch gaps are not counted.  A profile that
    recorded no device activity at all (torch.profiler drops a window
    now and then) is taken again, up to ``attempts`` times; if every one
    is empty, the time per back-to-back call by CUDA events stands in
    (``call_ms``, launch cost included), and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / n
    emit({"phase": "kernels", "check": f"torch.profiler recorded no device "
                                       f"time in {attempts} profiles: CUDA "
                                       f"events stand in"})
    return call_ms(fn, n=n, warmup=0)


def bound(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _errors(out, ref, dtype, tol, relative) -> tuple:
    """(max abs error, max error relative to max(1, |ref|), bf16 step
    excess, within the gate)."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    rel = (diff / ref.float().abs().clamp(min=1.0)).max().item()
    gated = rel if relative else err
    # bf16: how far the worst element lies beyond two rounding steps
    excess = ((diff - BF16_RTOL * ref.float().abs()).max().item()
              if dtype == "bfloat16" else None)
    ok = (bool(np.isfinite(gated)) and gated <= tol[dtype]
          and (excess is None or excess <= BF16_ATOL))
    return err, rel, excess, ok


def _case(name, dtype, shape, out, ref, fn, plain, library, nbytes, flops,
          tol=TOL, relative=False, library_note=None, prev=None,
          prev_out=None, extra=None, plain_calls=None):
    """One kernel case: ``out`` (kernel) against ``ref`` (plain) on the
    card, then the timings.  ``relative`` gates the error relative to
    max(1, |ref|) instead of the absolute one.  ``prev``: the kernel's
    previous (CUDA-core) body on the same inputs, gated the same way
    (on ``prev_out`` where given, else on what ``prev()`` returns) and
    timed in turns with the kernel (kernel, prev, prev, kernel).
    ``extra``: more keys for the case's line.  ``plain_calls``: time the
    plain version by CUDA events over that many back-to-back calls
    (``call_ms``, launch cost included: a plain version of thousands of
    launches a call, which torch.profiler takes minutes to record)."""
    import torch
    torch.cuda.synchronize()
    err, rel, excess, ok = _errors(out, ref, dtype, tol, relative)
    b_ms, b_by = bound(nbytes, flops, dtype)
    prev_case = {}
    if prev is None:
        ms = device_ms(fn)
    else:
        p_err, _, p_excess, p_ok = _errors(
            prev() if prev_out is None else prev_out, ref, dtype, tol,
            relative)
        turns = [device_ms(f) for f in (fn, prev, prev, fn)]
        ms = (turns[0] + turns[3]) / 2
        prev_case = {"prev_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns,
                     "prev_max_abs_err": p_err,
                     "prev_bf16_step_excess": p_excess}
        ok = ok and p_ok
    case = {"kernel": name, "dtype": dtype, "shape": shape,
            "max_abs_err": err, "max_rel_err": rel,
            "tol": tol[dtype], "tol_on": "relative" if relative else "abs",
            "bf16_step_excess": excess, "ok": ok,
            "ms": ms, "prev_ms": None, **prev_case,
            "plain_ms": (device_ms(plain) if plain_calls is None else
                         call_ms(plain, n=plain_calls, warmup=0)),
            "library_ms": device_ms(library) if library else None,
            "call_ms": call_ms(fn),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, **(extra or {})}
    if library_note:
        case["library_note"] = library_note
    emit({"phase": "kernels", **case})
    if not ok:
        raise AssertionError(f"{name} {dtype} {shape}: kernel disagrees "
                             f"with its plain version (max abs err {err}, "
                             f"max err relative to max(1, |plain|) {rel}, "
                             f"limit {tol[dtype]} on the "
                             f"{case['tol_on']} one; bf16 step excess "
                             f"{excess}, limit {BF16_ATOL}; previous body "
                             f"{prev_case})")
    return case


def kernel_cases(dev) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.flash_attention import (
        chunk_body, chunk_splits, paged_prefill_attention,
        paged_prefill_attention_plain)
    from repro_torch.kernels.rmsnorm import (add_rmsnorm, add_rmsnorm_plain,
                                             rmsnorm, rmsnorm_plain)

    rng = np.random.default_rng(SEED)
    cases = []
    H, KV, HD, BS, MAX_LEN, D = 15, 5, 64, 16, 1024, 960
    nb = MAX_LEN // BS

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8

        # rmsnorm: 8 decode rows, 128 prefill rows of d_model, and in
        # bf16 smollm-360m's train step (B 8 x S 4096 = 32768 rows, every
        # norm of the step and of its recompute) and the served models'
        # own widths: falcon-mamba-7b's 4096 (65 norms an iteration) and
        # gemma3-12b's 3840 (97 norms an iteration, 96 a chunk; 480
        # 16-byte accesses a row, so 8 warps with a partial second access
        # a lane, a launch shape no other width takes)
        widths = [(D, 8), (D, 128)] + ([(D, TRAIN_ROWS), (4096, 8),
                                        (4096, 128), (3840, 8), (3840, 128)]
                                       if dname == "bfloat16" else [])
        for d, rows in widths:
            x = t(rng.standard_normal((rows, d)), dtype)
            sc = t(1 + 0.1 * rng.standard_normal(d), dtype)
            cases.append(_case(
                "rmsnorm", dname, [rows, d], rmsnorm(x, sc, 1e-5),
                rmsnorm_plain(x, sc, 1e-5), lambda: rmsnorm(x, sc, 1e-5),
                lambda: rmsnorm_plain(x, sc, 1e-5),
                lambda: F.rms_norm(x, (d,), sc, 1e-5),
                2 * rows * d * es + d * es, 4 * rows * d,
                prev=(lambda: rmsnorm(x, sc, 1e-5, _body="cuda_core"))
                if dname == "bfloat16" else None,
                extra={"body": "norm"}))
        # fused with the residual add before it: the add_norm body of 64
        # of those 65 norms
        for d, rows in widths:
            x = t(rng.standard_normal((rows, d)), dtype)
            dl = t(rng.standard_normal((rows, d)), dtype)
            sc = t(1 + 0.1 * rng.standard_normal(d), dtype)
            r, out = add_rmsnorm(x, dl, sc, 1e-5)
            r_equal = torch.equal(r, x + dl)
            emit({"phase": "kernels", "kernel": "rmsnorm",
                  "check": "add_norm's r bit-equal to torch's x + delta",
                  "dtype": dname, "shape": [rows, d], "equal": r_equal})
            if not r_equal:
                raise AssertionError(f"add_rmsnorm {dname} {[rows, d]}: r "
                                     f"differs from torch's x + delta")
            cases.append(_case(
                "rmsnorm", dname, [rows, d], out,
                add_rmsnorm_plain(x, dl, sc, 1e-5)[1],
                lambda: add_rmsnorm(x, dl, sc, 1e-5),
                lambda: add_rmsnorm_plain(x, dl, sc, 1e-5), None,
                # x, delta read, r, out written; scale once; per element
                # the add, the square, its sum and two products
                (4 * rows * d + d) * es, 5 * rows * d,
                library_note="none: no single PyTorch call computes the "
                             "add and the norm; library_pair_ms is the "
                             "two-call pair torch.add, F.rms_norm",
                prev=lambda: add_rmsnorm(x, dl, sc, 1e-5,
                                         _body="cuda_core")[1],
                extra={"body": "add_norm", "library_pair_ms": device_ms(
                    lambda: F.rms_norm(x + dl, (d,), sc, 1e-5))}))

        # paged decode: B = 8 rows, positions up to ~600, one masked row
        # (frozen pos, all-zero table -> the scratch block 0)
        B = 8
        nbp = B * nb + 1
        kp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        vp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        tables_np = (rng.permutation(nbp - 1)[:B * nb].reshape(B, nb) + 1)
        pos_np = rng.integers(64, 640, size=B)
        tables_np[B - 1] = 0
        pos_np[B - 1] = 5
        tables = torch.from_numpy(tables_np.astype(np.int32)).to(dev)
        pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
        q = t(rng.standard_normal((B, H, HD)), dtype)
        kg = paged_gather(kp, tables).permute(0, 2, 1, 3).contiguous()
        vg = paged_gather(vp, tables).permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(MAX_LEN, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        n_keys = int(np.minimum(pos_np, MAX_LEN - 1).sum() + B)
        cases.append(_case(
            "paged_decode_attention", dname,
            {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS,
             "pos": pos_np.tolist()},
            paged_decode_attention(q, kp, vp, tables, pos),
            paged_decode_attention_plain(q, kp, vp, tables, pos),
            lambda: paged_decode_attention(q, kp, vp, tables, pos),
            lambda: paged_decode_attention_plain(q, kp, vp, tables, pos),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True),
            2 * B * H * HD * es + 2 * n_keys * KV * HD * es
            + 4 * (n_keys // BS + B) + 4 * B,
            4 * H * HD * n_keys,
            prev=(lambda: paged_decode_attention(q, kp, vp, tables, pos,
                                                 _body="cuda_core"))
            if dname == "bfloat16" else None))

        # paged prefill: a chunk of C = 128 at pos 0 (identity table over
        # contiguous K/V) and at pos 256 (shuffled table)
        C = 128
        for p0 in (0, 256):
            nbp = nb + 1
            kp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
            vp = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
            if p0 == 0:
                table_np = np.arange(nb)
            else:
                table_np = rng.permutation(nbp - 1)[:nb] + 1
            table = torch.from_numpy(table_np.astype(np.int32)).to(dev)
            q = t(rng.standard_normal((C, H, HD)), dtype)
            n_slots = p0 + C
            kc = paged_gather(kp, table[None])[0, :n_slots].permute(1, 0, 2)
            vc = paged_gather(vp, table[None])[0, :n_slots].permute(1, 0, 2)
            kc, vc = kc[None].contiguous(), vc[None].contiguous()
            qs = q.permute(1, 0, 2)[None].contiguous()
            cmask = (torch.arange(n_slots, device=dev)[None, :]
                     <= p0 + torch.arange(C, device=dev)[:, None])
            body = chunk_body(dtype, HD)
            out = (chunk_bits(dev, "smollm-360m", q, kp, vp, table, p0)
                   if dname == "bfloat16" else
                   paged_prefill_attention(q, kp, vp, table, p0))
            if p0 == 0:
                # what flash_attention_pallas(causal=True) computes for
                # contiguous K/V, written out in f32
                g = H // KV
                s = torch.einsum("nghd,nkd->nghk",
                                 qs[0].float().reshape(KV, g, C, HD),
                                 kc[0].float()) * HD ** -0.5
                s = s.masked_fill(~cmask, -1e30)
                ref = torch.einsum("nghk,nkd->nghd", torch.softmax(s, -1),
                                   vc[0].float()).reshape(H, C, HD)
                flash_err = (out.float().permute(1, 0, 2) - ref).abs().max().item()
                emit({"phase": "kernels", "kernel": "paged_prefill_attention",
                      "check": "identity table vs contiguous causal attention",
                      "dtype": dname, "max_abs_err": flash_err,
                      "tol": TOL[dname]})
                if not flash_err <= TOL[dname]:
                    raise AssertionError(
                        f"prefill at pos 0 disagrees with contiguous causal "
                        f"attention ({flash_err})")
            n_pairs = sum(p0 + i + 1 for i in range(C))
            nbytes = (2 * C * H * HD * es + 2 * n_slots * KV * HD * es
                      + 4 * (-(-n_slots // BS)))
            flops = 4 * H * HD * n_pairs
            cases.append(_case(
                "paged_prefill_attention", dname,
                {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "pos": p0},
                out, paged_prefill_attention_plain(q, kp, vp, table, p0),
                lambda: paged_prefill_attention(q, kp, vp, table, p0),
                lambda: paged_prefill_attention_plain(q, kp, vp, table, p0),
                (lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, is_causal=True, enable_gqa=True))
                if p0 == 0 else
                (lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=cmask, enable_gqa=True)),
                nbytes, flops,
                prev=(lambda: paged_prefill_attention(
                    q, kp, vp, table, p0, _body=_turn_body(body)))
                if dname == "bfloat16" else None,
                extra={"model": "smollm-360m", "body": body,
                       **({"prev_body": _turn_body(body),
                           "splits": chunk_splits(C, H, KV, HD, nb * BS)}
                          if dname == "bfloat16" else {}),
                       **_bounds(nbytes, flops, dname)}))

        cases.append(chunk_case(dev, dname))

    # the kernels of the quantized and slot-engine paths
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8

        # quant matmul at a decode site (8 rows, w_gate / w_up) and a
        # prefill one (a chunk of 128 rows, w_down): qmm_case
        for m, k, n in ((8, 960, 2560), (128, 2560, 960)):
            w = t(rng.standard_normal((k, n)) * k ** -0.5, torch.float32)
            x = t(rng.standard_normal((m, k)), dtype)
            for fmt in ("int8", "int4"):
                cases.append(qmm_case(fmt, x, w, {"model": "smollm-360m"},
                                      cold=dname == "bfloat16"))

        # dense decode: the slot engine's 8 rows of S = 1024 slots,
        # positions up to ~600, one row frozen at pos 5 (budget run out)
        B, S = 8, 1024
        kc = t(rng.standard_normal((B, S, KV, HD)), dtype)
        vc = t(rng.standard_normal((B, S, KV, HD)), dtype)
        pos_np = rng.integers(64, 640, size=B)
        pos_np[B - 1] = 5
        pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
        q = t(rng.standard_normal((B, H, HD)), dtype)
        kt = kc.permute(0, 2, 1, 3).contiguous()
        vt = vc.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(S, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        n_keys = int(np.minimum(pos_np, S - 1).sum() + B)
        cases.append(_case(
            "dense_decode_attention", dname,
            {"B": B, "H": H, "KV": KV, "hd": HD, "S": S,
             "pos": pos_np.tolist()},
            dense_decode_attention(q, kc, vc, pos),
            dense_decode_attention_plain(q, kc, vc, pos),
            lambda: dense_decode_attention(q, kc, vc, pos),
            lambda: dense_decode_attention_plain(q, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            2 * B * H * HD * es + 2 * n_keys * KV * HD * es + 4 * B,
            4 * H * HD * n_keys,
            prev=(lambda: dense_decode_attention(q, kc, vc, pos,
                                                 _body="cuda_core"))
            if dname == "bfloat16" else None))
    launch_floor(dev)
    return (cases + target_cases(dev) + scan_cases(dev)
            + scan_backward_cases(dev) + gemma_cases(dev)
            + mixtral_cases(dev) + zamba_cases(dev) + cross_cases(dev)
            + cross_fn_cases(dev) + flash_cases(dev))


#: qwen2-72b's MLP at decode: 8 rows through w_gate / w_up (8192 ->
#: 29568) and w_down (29568 -> 8192); then at a prefill chunk of 128 rows
TARGET_QMM = ((8, 8192, 29568), (8, 29568, 8192), (128, 8192, 29568),
              (128, 29568, 8192))
#: the weight-only library calls' gate against the plain version: their
#: scales are bf16, which moves each scale by up to 2^-9 of itself, an
#: output of a few units by up to about 1e-2; a wrong layout moves it by
#: its own size
QMM_LIB_TOL = 5e-2
#: bytes of distinct weight copies a cold-L2 timing streams through, one
#: copy a launch: twice the H100's 50 MB L2
COLD_BYTES = 100e6


def weight_only_call(fmt, x, q, s):
    """One PyTorch call that computes the weight-only product itself, on
    the card, timed beside the kernel and never called by the port:
    ``torch._weight_int8pack_mm(x, q^T, s)`` (scales in x's dtype) for
    int8; ``torch._weight_int4pack_mm`` on
    ``torch._convert_weight_to_int4pack``'s packing of the nibbles for
    int4 (the group of s, zero point 0, scales in bf16).  Returns (fn,
    its output, the call's name), or (None, the reason, the name) where
    this card's torch refuses it."""
    import torch
    from repro_torch.kernels.quant_matmul import unpack_int4
    k, n = x.shape[-1], q.shape[-1]
    try:
        if fmt == "int8":
            name = "torch._weight_int8pack_mm"
            qt = q.t().contiguous()                       # (N, K) int8
            sc = s.reshape(n).to(x.dtype).contiguous()

            def fn():
                return torch._weight_int8pack_mm(x, qt, sc)
        else:
            name = "torch._weight_int4pack_mm"
            group = k // s.shape[0]
            nib = (unpack_int4(q).to(torch.int32) + 8).t().contiguous()
            packed = ((nib[:, ::2] << 4) | nib[:, 1::2]).to(torch.uint8)
            del nib
            tiles = next(t for t in (8, 4, 2) if k % (16 * t) == 0)
            w4 = torch._convert_weight_to_int4pack(packed, tiles)
            del packed
            sz = torch.stack([s, torch.zeros_like(s)], dim=-1).to(
                x.dtype).contiguous()                     # (K/G, N, 2)

            def fn():
                return torch._weight_int4pack_mm(x, w4, group, sz)
        out = fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError, NotImplementedError,
            StopIteration) as e:
        return None, (f"{type(e).__name__}: {str(e)[:300]}"), (
            "torch._weight_int8pack_mm" if fmt == "int8"
            else "torch._weight_int4pack_mm")
    return fn, out, name


def cold_ms(launch, copies) -> dict:
    """Time per launch with the weights cold in L2: ``launch(c)`` on each
    of ``copies`` in turn (distinct weights, together past the 50 MB
    L2), so no launch finds its weights warm: the device time summed over
    the launches' kernels (torch.profiler, as ``device_ms``) and the CUDA
    events' time over the back-to-back launches (host launch cost
    included where it is the longer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for c in copies:
        launch(c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in copies:
            launch(c)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for c in copies:
        launch(c)
    end.record()
    torch.cuda.synchronize()
    return {"device_ms": us / 1e3 / len(copies),
            "event_ms": start.elapsed_time(end) / len(copies),
            "copies": len(copies)}


def qmm_case(fmt, x, w, extra, cold=False) -> dict:
    """The int8 / int4 quant matmul of x (M, K) on w (K, N), packed here:
    the rule's body against the plain version, and in bf16 against the
    other tensor-core body (``mma`` where the rule names ``wgmma``, else
    ``wgmma``) on the same inputs, in turns (``prev``), bit-equal over
    repeated launches; the library calls ``torch.matmul`` on the dense
    weight (``library_ms``) and, in bf16, the weight-only call
    (``weight_only_call``: gated against the plain version within
    ``QMM_LIB_TOL`` before it is timed, or its refusal in
    ``library_note``); both halves of the bound; with ``cold``, the
    kernel's, the other body's and ``torch.matmul``'s times with their
    weights cold in L2 (``cold_ms``)."""
    import torch
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.models.quantize import (dequantize, quantize_int4,
                                             quantize_int8)
    m, k = x.shape
    n = w.shape[1]
    dname = str(x.dtype).split(".")[-1]
    es = x.element_size()
    packed = (quantize_int8 if fmt == "int8" else quantize_int4)(w)
    q, s = packed["q"], packed["s"]
    w_dense = dequantize(packed).to(x.dtype)
    kernel, plain = ((qm.quant_matmul_int8, qm.quant_matmul_int8_plain)
                     if fmt == "int8" else
                     (qm.quant_matmul_int4, qm.quant_matmul_int4_plain))
    name = f"quant_matmul_{fmt}"
    group = k // s.shape[0]
    body = (qm.int8_body(x.dtype, k, n) if fmt == "int8"
            else qm.int4_body(x.dtype, m, k, n, group))
    out = _on_body(name, body, lambda: kernel(x, q, s))
    ref = plain(x, q, s)
    bits = all(torch.equal(kernel(x, q, s), out) for _ in range(3))
    nbytes = m * k * es + q.numel() + 4 * s.numel() + m * n * es
    flops = 2 * m * k * n
    more = {"body": body, "bits_equal_over_launches": bits, **extra,
            **_bounds(nbytes, flops, dname)}
    bf16 = dname == "bfloat16"
    note = None
    prev_body = _turn_body(body)

    def split_of(b):
        return (qm.wgmma_splits(fmt, m, k, n) if b == "wgmma"
                else qm.quant_splits(m, k, n))
    if bf16:
        more.update(prev_body=prev_body, splits=split_of(body),
                    prev_splits=split_of(prev_body))
        fn, lib_out, lib_name = weight_only_call(fmt, x, q, s)
        more["library_weight_only"] = lib_name
        if fn is None:
            note = f"{lib_name} refused on this card: {lib_out}"
        else:
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
            more.update(library_weight_only_max_abs_err=lib_err,
                        library_weight_only_tol=QMM_LIB_TOL)
            if lib_err <= QMM_LIB_TOL:
                more["library_weight_only_ms"] = device_ms(fn)
            else:
                note = (f"{lib_name} disagrees with the plain version by "
                        f"{lib_err} (> {QMM_LIB_TOL}): not timed")
            del fn, lib_out
    if cold:
        ncopy = int(-(-COLD_BYTES // (q.numel() + 4 * s.numel())))
        qs = [(q.clone(), s.clone()) for _ in range(ncopy)]
        ws = [w_dense.clone() for _ in range(
            int(-(-COLD_BYTES // (w_dense.numel() * es))))]
        more["cold"] = {
            "kernel": cold_ms(lambda c: kernel(x, *c), qs),
            prev_body: cold_ms(lambda c: kernel(x, *c, _body=prev_body), qs),
            "torch_matmul": cold_ms(lambda c: torch.matmul(x, c), ws)}
        more["cold_ms"] = more["cold"]["kernel"]["device_ms"]
        del qs, ws
    case = _case(name, dname, [m, k, n], out, ref,
                 lambda: kernel(x, q, s), lambda: plain(x, q, s),
                 lambda: torch.matmul(x, w_dense), nbytes, flops,
                 tol=QMM_TOL, library_note=note,
                 prev=((lambda: kernel(x, q, s, _body=prev_body)) if bf16
                       else None),
                 extra=more)
    if not bits:
        raise AssertionError(f"{name} {[m, k, n]} on {body}: repeated "
                             f"launches differ")
    return case


def target_cases(dev) -> list:
    """The speculation targets' new shapes for ported kernels, in bf16:
    the batched paged-chunk form at qwen2-72b's verify round (64 / 8
    heads of 128, G 8; ``chunk_case``: its ``wgmma`` body against the
    previous ``mma`` in turns) and the int8 / int4 quant matmul at
    qwen2-72b's MLP widths, decode and a prefill chunk (``TARGET_QMM``;
    ``qmm_case``: the rule's body against the ``mma`` body in turns),
    each against its plain version, the library calls (SDPA;
    ``torch.matmul`` on the dense bf16 weight and the weight-only call)
    and its bound.  The weights are drawn on the card (a CPU draw of
    242 M values takes seconds)."""
    import torch
    cases = [chunk_case(dev, "bfloat16", "qwen2-72b")]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for m, k, n in TARGET_QMM:
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        for fmt in ("int8", "int4"):
            cases.append(qmm_case(fmt, x, w, {"config": "qwen2-72b"}))
            torch.cuda.empty_cache()
        del w
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase 3 (continued): the contiguous flash form and the gradients
# ---------------------------------------------------------------------------
#: the contiguous flash form's cases: (label, dtype, B, S, H, KV, hd,
#: causal, window).  "train": smollm-360m's train shape (the reference's
#: train_4k sequence on one card's 8 rows), on wgmma, mma in turns;
#: "train_f32": the same heads at S 1024 in float32, on cuda_core;
#: "gemma": gemma3-12b's heads with its window (mma, the wide tiles);
#: "encoder": non-causal and ragged, with a window the kernel must ignore
#: (bf16: wgmma, mma in turns); "seamless_encoder": seamless-m4t-medium's
#: encoder in Model.prefill (8 rows of its 1024 frames, 16 / 16 heads of
#: 64, non-causal; wgmma, mma in turns); "seamless_prefill" and
#: "vision_prefill": Model.prefill's decoder self-attention over 8
#: prompts of 128 (hd 64 G 1 and llama-3.2-vision-90b's hd 128 G 8, on
#: wgmma, mma in turns); "hd128_long": one row of 4096 at hd 128, where
#: the tensor cores and not latency set the pace (wgmma, mma in turns);
#: "zamba_train": zamba2-7b's train shape (its train run's B 2, S 2048,
#: 32 / 32 heads of 112, causal; wgmma on the hd-128 body, mma in turns)
FLASH_CASES = [("train", "bfloat16", 8, 4096, 15, 5, 64, True, 0),
               ("train_f32", "float32", 8, 1024, 15, 5, 64, True, 0),
               ("gemma", "bfloat16", 1, 4096, 16, 8, 256, True, 1024),
               ("encoder", "float32", 2, 1000, 6, 2, 64, False, 100),
               ("encoder", "bfloat16", 2, 1000, 6, 2, 64, False, 100),
               ("seamless_encoder", "bfloat16", 8, 1024, 16, 16, 64, False,
                0),
               ("seamless_prefill", "bfloat16", 8, 128, 16, 16, 64, True, 0),
               ("vision_prefill", "bfloat16", 8, 128, 64, 8, 128, True, 0),
               ("hd128_long", "bfloat16", 1, 4096, 32, 8, 128, True, 0),
               ("zamba_train", "bfloat16", 2, 2048, 32, 32, 112, True, 0)]
FLASH_LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head of one row computes: S^2 when not
    causal, S(S + 1)/2 causal, and with a window w < S, w(w + 1)/2 +
    (S - w) w."""
    if not causal:
        return s * s
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _grad_err(got, want) -> float:
    """Largest gradient difference relative to max(1, |want|)."""
    return max(((g.float() - w.float()).abs()
                / w.float().abs().clamp(min=1.0)).max().item()
               for g, w in zip(got, want))


def flash_cases(dev) -> list:
    """The contiguous flash form (``flash_attention``, the TPU kernel's
    own signature) at ``FLASH_CASES``: out against the plain version
    under the gates, the row log-sum-exp within ``FLASH_LSE_TOL``, each
    launch on the body ``flash_body`` names (where that is ``wgmma``, the
    model's ``(B, S, heads, hd)`` layout as transposed views too, bit for
    bit, and the ``mma`` body, gated the same way, lse included, and timed
    in turns as ``prev``), timed beside its plain version and
    ``F.scaled_dot_product_attention`` (``enable_gqa``;
    ``is_causal``, or the boolean window mask where there is a window);
    at the train shape also the torch-op gradient
    (``flash_attention_backward``, one layer's).  Then
    ``FlashAttentionFn``'s dq / dk / dv and the norms' gradients
    (``rmsnorm``, ``add_rmsnorm`` through their autograd Functions, on
    the kernels) against autograd through the plain versions on the
    card, within TOL of max(1, |g|)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention, flash_attention_backward,
        flash_attention_plain, flash_body)
    from repro_torch.kernels.rmsnorm import (add_rmsnorm, add_rmsnorm_plain,
                                             rmsnorm, rmsnorm_plain)
    rng = np.random.default_rng(SEED + 11)
    cases = []

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    for label, dname, B, S, H, KV, HD, causal, window in FLASH_CASES:
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        q, k, v = t((B, H, S, HD), dtype), t((B, KV, S, HD), dtype), t(
            (B, KV, S, HD), dtype)
        kw = dict(causal=causal, window=window)
        body = flash_body(dtype, HD)
        out, lse = _on_body("flash_attention", body,
                            lambda: flash_attention(q, k, v, **kw))
        ref, ref_lse = flash_attention_plain(q, k, v, **kw)
        lse_err = (lse - ref_lse).abs().max().item()
        prev = prev_out = None
        if body == "wgmma":
            # the model's layout: (B, S, heads, hd) tensors passed as
            # transposed views (models/attention.py), which the body reads
            # through other tensor maps; the bits of the contiguous run
            views = [a.transpose(1, 2).contiguous().transpose(1, 2)
                     for a in (q, k, v)]
            view_out, view_lse = _on_body(
                "flash_attention", body,
                lambda: flash_attention(*views, **kw))
            if not (view_out.transpose(1, 2).is_contiguous()
                    and torch.equal(view_out, out)
                    and torch.equal(view_lse, lse)):
                raise AssertionError(
                    f"flash_attention {label} {dname}: the model's strided "
                    f"views give other bits than contiguous tensors (out "
                    f"off by {(view_out.float() - out.float()).abs().max()}"
                    f", lse by {(view_lse - lse).abs().max()})")
            del views, view_out, view_lse
            # the previous body, in turns
            prev_out, prev_lse = _on_body(
                "flash_attention", "mma",
                lambda: flash_attention(q, k, v, **kw, _body="mma"))
            lse_err = max(lse_err, (prev_lse - ref_lse).abs().max().item())
            del prev_lse

            def prev():
                return flash_attention(q, k, v, **kw, _body="mma")
        if causal and window:
            pos = torch.arange(S, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib_kw = dict(attn_mask=mask)
        else:
            lib_kw = dict(is_causal=causal)
        pairs = flash_pairs(S, causal, window if causal else 0)
        nbytes = (2 * B * H + 2 * B * KV) * S * HD * es + 4 * B * H * S
        flops = 4 * HD * B * H * pairs
        extra = {"body": body, "lse_max_abs_err": lse_err,
                 **({"model_layout": "bit-equal to contiguous"}
                    if body == "wgmma" else {}),
                 "lse_tol": FLASH_LSE_TOL[dname],
                 **_bounds(nbytes, flops, dname)}
        if label == "train":
            dout = t((B, H, S, HD), dtype)
            extra["backward_ms"] = device_ms(
                lambda: flash_attention_backward(q, k, v, out, lse, dout,
                                                 **kw), n=5, warmup=1)
            extra["backward_note"] = ("flash_attention_backward, torch "
                                      "ops, one layer's gradient")
            del dout
        cases.append(_case(
            "flash_attention", dname,
            {"label": label, "B": B, "S": S, "H": H, "KV": KV, "hd": HD,
             "causal": causal, "window": window}, out, ref,
            lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                   **lib_kw),
            nbytes, flops, prev=prev, prev_out=prev_out, extra=extra))
        if not lse_err <= FLASH_LSE_TOL[dname]:
            raise AssertionError(f"flash_attention {label} {dname}: row "
                                 f"log-sum-exp off by {lse_err}")
        del q, k, v, out, lse, ref, ref_lse, lib_kw, prev, prev_out
        torch.cuda.empty_cache()

    # gradients: FlashAttentionFn (the kernel's forward, the torch-op
    # backward) against autograd through the plain version
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for causal, window in ((True, 0), (True, 128), (False, 0)):
            x = [t(shape, dtype) for shape in ((2, 15, 512, 64),
                                               (2, 5, 512, 64),
                                               (2, 5, 512, 64))]
            w = t((2, 15, 512, 64), torch.float32)
            a = [y.clone().requires_grad_(True) for y in x]
            got = torch.autograd.grad((FlashAttentionFn.apply(
                *a, causal, window, None).float() * w).sum(), a)
            p = [y.clone().requires_grad_(True) for y in x]
            want = torch.autograd.grad((flash_attention_plain(
                *p, causal=causal, window=window)[0].float() * w).sum(), p)
            err = _grad_err(got, want)
            emit({"phase": "kernels", "kernel": "flash_attention",
                  "check": "FlashAttentionFn dq, dk, dv vs autograd through "
                           "the plain version", "dtype": dname,
                  "shape": {"B": 2, "S": 512, "H": 15, "KV": 5, "hd": 64,
                            "causal": causal, "window": window},
                  "max_rel_err": err, "tol": TOL[dname]})
            if not err <= TOL[dname]:
                raise AssertionError(f"flash_attention gradients {dname}: "
                                     f"{err} of max(1, |g|)")

    # the norms' gradients: rmsnorm and add_rmsnorm through their
    # autograd Functions (the norm / add_norm kernels forward, torch ops
    # backward) against autograd through the plain versions, in bf16
    # also at the train step's rows; the Functions' forward outputs (the
    # train path's own calls) held to the kernels' gate
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for rows in (8, 128) + ((TRAIN_ROWS,) if dname == "bfloat16"
                                else ()):
            x, dl, dout, dr = (t((rows, 960), dtype) for _ in range(4))
            sc = (1 + 0.1 * t((960,), torch.float32)).to(dtype)
            a = [y.clone().requires_grad_(True) for y in (x, sc)]
            o = rmsnorm(*a, 1e-5)
            got = torch.autograd.grad((o.float() * dout.float()).sum(), a)
            p = [y.clone().requires_grad_(True) for y in (x, sc)]
            o_plain = rmsnorm_plain(*p, 1e-5)
            want = torch.autograd.grad((o_plain.float()
                                        * dout.float()).sum(), p)
            err_norm = _grad_err(got, want)
            fwd_norm = _errors(o.detach(), o_plain.detach(), dname, TOL,
                               False)
            a = [y.clone().requires_grad_(True) for y in (x, dl, sc)]
            r, o = add_rmsnorm(*a, 1e-5)
            got = torch.autograd.grad((r.float() * dr.float()).sum()
                                      + (o.float() * dout.float()).sum(), a)
            p = [y.clone().requires_grad_(True) for y in (x, dl, sc)]
            r_plain, o_plain = add_rmsnorm_plain(*p, 1e-5)
            want = torch.autograd.grad(
                (r_plain.float() * dr.float()).sum()
                + (o_plain.float() * dout.float()).sum(), p)
            err_add = _grad_err(got, want)
            fwd_add = _errors(o.detach(), o_plain.detach(), dname, TOL,
                              False)
            r_equal = torch.equal(r.detach(), r_plain.detach())
            emit({"phase": "kernels", "kernel": "rmsnorm",
                  "check": "rmsnorm and add_rmsnorm gradients vs autograd "
                           "through the plain versions, and the "
                           "Functions' forward vs the plain forward",
                  "dtype": dname, "shape": [rows, 960],
                  "rmsnorm_max_rel_err": err_norm,
                  "add_rmsnorm_max_rel_err": err_add, "tol": TOL[dname],
                  "rmsnorm_forward_max_abs_err": fwd_norm[0],
                  "add_rmsnorm_forward_max_abs_err": fwd_add[0],
                  "forward_bf16_step_excess": [fwd_norm[2], fwd_add[2]],
                  "forward_ok": fwd_norm[3] and fwd_add[3],
                  "add_rmsnorm_r_equal": r_equal})
            if not max(err_norm, err_add) <= TOL[dname]:
                raise AssertionError(f"rmsnorm gradients {dname} {rows}: "
                                     f"{err_norm}, {err_add}")
            if not (fwd_norm[3] and fwd_add[3] and r_equal):
                raise AssertionError(f"rmsnorm Functions' forward {dname} "
                                     f"{rows}: {fwd_norm}, {fwd_add}, r "
                                     f"equal {r_equal}")
            del x, dl, dout, dr, a, p, got, want, o, o_plain, r, r_plain
    return cases


#: the verify round's rows: smollm-360m's 8 rows at positions 32-600
VERIFY_POS = [32, 600, 117, 256, 75, 413, 519, 188]
#: the verify round's attention heads: smollm-360m's (15 / 5 of 64) and
#: the speculation target qwen2-72b's (64 / 8 of 128, G 8)
VERIFY_HEADS = {"smollm-360m": (15, 5, 64), "qwen2-72b": (64, 8, 128)}


def chunk_case(dev, dname, arch="smollm-360m") -> dict:
    """The batched paged-chunk form at a verify round's shapes (B 8, C = K
    + 1 = 5, ``arch``'s heads, blocks of 16 of 1024-slot rows, each row's
    pos on the device): against its plain version under the gates, each
    row bit-equal to a one-row call at its pos, and the same data in
    blocks of 32 bit-equal; then timed (in bf16 on ``chunk_body``'s body,
    against the other of ``wgmma`` and ``mma`` in turns), with
    ``F.scaled_dot_product_attention`` over the gathered KV and a per-row
    mask as the library call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import paged_gather
    from repro_torch.kernels.flash_attention import (
        chunk_body, chunk_splits, paged_chunk_attention,
        paged_chunk_attention_plain, paged_prefill_attention)
    rng = np.random.default_rng(SEED + 8)
    dtype = getattr(torch, dname)
    es = torch.finfo(dtype).bits // 8
    (H, KV, HD), B, C, S = VERIFY_HEADS[arch], 8, 5, 1024
    pos_np = np.asarray(VERIFY_POS, np.int32)
    k = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((B, C, H, HD)).astype(
        np.float32)).to(dev, dtype)
    pos = torch.from_numpy(pos_np).to(dev)
    pools = {}
    for bs in (16, 32):
        nb = S // bs
        tables_np = (rng.permutation(B * nb).reshape(B, nb) + 1).astype(
            np.int32)
        kp = np.zeros((B * nb + 1, bs, KV, HD), np.float32)
        vp = np.zeros((B * nb + 1, bs, KV, HD), np.float32)
        kp[tables_np] = k.reshape(B, nb, bs, KV, HD)
        vp[tables_np] = v.reshape(B, nb, bs, KV, HD)
        pools[bs] = [torch.from_numpy(a).to(dev, dtype) for a in (kp, vp)] + [
            torch.from_numpy(tables_np).to(dev)]
    kp, vp, tables = pools[16]
    body = chunk_body(dtype, HD)
    out = _on_body("paged_chunk_attention", body,
                   lambda: paged_chunk_attention(q, kp, vp, tables, pos))
    rows_equal = all(torch.equal(out[b], paged_prefill_attention(
        q[b].contiguous(), kp, vp, tables[b].contiguous(), int(pos_np[b])))
        for b in range(B))
    blocks_equal = torch.equal(out, paged_chunk_attention(q, *pools[32][:2],
                                                          pools[32][2], pos))
    emit({"phase": "kernels", "kernel": "paged_chunk_attention",
          "check": "rows bit-equal to one-row calls; blocks of 32 bit-equal "
                   "to blocks of 16", "dtype": dname, "heads": [H, KV, HD],
          "rows_equal": rows_equal, "blocks_equal": blocks_equal})
    if not (rows_equal and blocks_equal):
        raise AssertionError(f"paged_chunk_attention {dname}: rows equal to "
                             f"one-row calls {rows_equal}, blocks of 32 "
                             f"equal {blocks_equal}")
    kg = paged_gather(kp, tables).permute(0, 2, 1, 3).contiguous()
    vg = paged_gather(vp, tables).permute(0, 2, 1, 3).contiguous()
    qs = q.permute(0, 2, 1, 3).contiguous()                  # (B,H,C,hd)
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= pos.long()[:, None, None]
            + torch.arange(C, device=dev)[None, :, None])[:, None]
    n_slots = int((pos_np + C).sum())
    n_entries = sum(-(-(int(p) + C) // 16) for p in pos_np)
    n_pairs = int(sum(p + i + 1 for p in pos_np for i in range(C)))
    # q read, out written; each row's pos + C slots of K and V; its table
    # entries and pos
    nbytes = (2 * B * C * H * HD * es + 2 * n_slots * KV * HD * es
              + 4 * n_entries + 4 * B)
    flops = 4 * H * HD * n_pairs
    return _case(
        "paged_chunk_attention", dname,
        {"B": B, "C": C, "H": H, "KV": KV, "hd": HD, "bs": 16,
         "pos": pos_np.tolist(), "config": arch},
        out, paged_chunk_attention_plain(q, kp, vp, tables, pos),
        lambda: paged_chunk_attention(q, kp, vp, tables, pos),
        lambda: paged_chunk_attention_plain(q, kp, vp, tables, pos),
        lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                               enable_gqa=True),
        nbytes, flops,
        prev=(lambda: paged_chunk_attention(q, kp, vp, tables, pos,
                                            _body=_turn_body(body)))
        if dname == "bfloat16" else None,
        extra={"body": body,
               **({"prev_body": _turn_body(body),
                   "splits": chunk_splits(C, H, KV, HD, S)}
                  if dname == "bfloat16" else {}),
               **_bounds(nbytes, flops, dname)})


#: gemma3-12b's attention: 16 query heads over 8 KV heads of 256, a ring
#: of w = 1024 slots, chunks of 128, rows of max_len 2176
GEMMA = {"H": 16, "KV": 8, "hd": 256, "w": 1024, "C": 128, "max_len": 2176}
#: a decode batch's positions, 5-2000: before, at and past the ring's wrap
GEMMA_DECODE_POS = [5, 300, 1022, 1023, 1024, 1500, 1777, 2000]


def _bounds(nbytes, flops, dtype) -> dict:
    """Both halves of the bound, for the cases that print them."""
    return {"bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "flops_bound_ms": flops / PEAK_FLOPS[dtype] * 1e3}


def gemma_cases(dev) -> list:
    """The attention kernels at gemma3-12b's shapes (hd 256: in bf16 on
    their wide ``mma`` bodies, in float32 on ``cuda_core``).

    ``ring_chunk_attention``, the flash kernel's window form, in float32
    and bfloat16 at pos 0 (no ring key valid), 512 (ring partly filled)
    and 3000 (wrapped): against its plain version under the gates, the
    same ring in blocks of 32 and as a dense one-block ring bit-equal to
    blocks of 16, pos as a (1,) int32 tensor on the card bit-equal to the
    host int (in bf16 on both bodies), and timed (bf16 in turns against
    ``cuda_core``), with ``F.scaled_dot_product_attention`` over
    ``[gathered ring ; chunk]`` and the boolean window mask as the library
    call.  Then the one-row paged prefill (C 128) in bfloat16 at pos
    1024 and 2048, on ``mma`` against ``cuda_core`` in turns, its bits
    the same in blocks of 16, 32 and one dense block, and in float32 at
    pos 1024 on ``cuda_core``; and both decode kernels (B 8, pos 5-2000)
    in bfloat16 over linear rows of 2176 slots and over rings of 1024 (at
    the pos the model clamps to w - 1), on ``mma`` against ``cuda_core``
    in turns, the dense kernel bit-equal to the paged one on the same
    rows, and in float32 over linear rows on ``cuda_core``: as the gemma3
    serve runs launch them.  Each launch is checked on its body."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.flash_attention import (
        paged_prefill_attention, paged_prefill_attention_plain,
        ring_chunk_attention, ring_chunk_attention_plain, ring_positions)
    rng = np.random.default_rng(SEED + 9)
    H, KV, HD, W, C = (GEMMA[k] for k in ("H", "KV", "hd", "w", "C"))
    BS, cases = 16, []

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        body = "mma" if dname == "bfloat16" else "cuda_core"
        for pos in (0, 512, 3000):
            nb = W // BS
            ring_k = rng.standard_normal((W, KV, HD)).astype(np.float32)
            ring_v = rng.standard_normal((W, KV, HD)).astype(np.float32)
            table_np = (rng.permutation(nb) + 1).astype(np.int32)
            pools = []
            for ring in (ring_k, ring_v):
                pool = np.zeros((nb + 1, BS, KV, HD), np.float32)
                pool[table_np] = ring.reshape(nb, BS, KV, HD)
                pools.append(t(pool, dtype))
            kp, vp = pools
            table = torch.from_numpy(table_np).to(dev)
            q = t(rng.standard_normal((C, H, HD)), dtype)
            kn = t(rng.standard_normal((C, KV, HD)), dtype)
            vn = t(rng.standard_normal((C, KV, HD)), dtype)
            out = _on_body("ring_chunk_attention", body,
                           lambda: ring_chunk_attention(q, kp, vp, table, kn,
                                                        vn, pos, W))
            # pos read on the device: the host-int call's bits, on both
            # bodies in bf16
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            device_pos_equal = {b: torch.equal(
                out if b == body else ring_chunk_attention(
                    q, kp, vp, table, kn, vn, pos, W, _body=b),
                ring_chunk_attention(q, kp, vp, table, kn, vn, pos_t, W,
                                     _body=b))
                for b in ((body, "cuda_core") if body == "mma" else (body,))}
            # the same ring in blocks of 32 (identity table) and as one
            # dense block of W slots
            k32 = t(ring_k, dtype).reshape(W // 32, 32, KV, HD)
            v32 = t(ring_v, dtype).reshape(W // 32, 32, KV, HD)
            t32 = torch.arange(W // 32, dtype=torch.int32, device=dev)
            blocks_equal = torch.equal(out, ring_chunk_attention(
                q, k32, v32, t32, kn, vn, pos, W))
            dense_equal = torch.equal(out, ring_chunk_attention(
                q, k32.reshape(1, W, KV, HD), v32.reshape(1, W, KV, HD),
                t32[:1], kn, vn, pos, W))
            emit({"phase": "kernels", "kernel": "ring_chunk_attention",
                  "check": "blocks of 32 and a dense one-block ring "
                           "bit-equal to blocks of 16; device pos bit-equal "
                           "to host pos", "dtype": dname, "body": body,
                  "pos": pos, "blocks_equal": blocks_equal,
                  "dense_equal": dense_equal,
                  "device_pos_equal": device_pos_equal})
            if not (blocks_equal and dense_equal
                    and all(device_pos_equal.values())):
                raise AssertionError(f"ring_chunk_attention {dname} pos "
                                     f"{pos}: blocks of 32 equal "
                                     f"{blocks_equal}, dense ring equal "
                                     f"{dense_equal}, device pos equal "
                                     f"{device_pos_equal}")
            kpos = ring_positions(pos, W, C, dev)[None, :]
            qpos = pos + torch.arange(C, device=dev)[:, None]
            valid = (kpos >= 0) & (kpos <= qpos) & (kpos > qpos - W)
            k_all = torch.cat([paged_gather(kp, table[None])[0], kn])
            v_all = torch.cat([paged_gather(vp, table[None])[0], vn])
            k_all = k_all.permute(1, 0, 2)[None].contiguous()
            v_all = v_all.permute(1, 0, 2)[None].contiguous()
            qs = q.permute(1, 0, 2)[None].contiguous()
            n_old = min(pos, W)
            # q read, out written; the ring slots that hold a position
            # and the chunk's keys, K and V; their table entries
            nbytes = (2 * C * H * HD * es + 2 * (n_old + C) * KV * HD * es
                      + 4 * -(-n_old // BS))
            flops = 4 * HD * H * int(valid.sum())
            cases.append(_case(
                "ring_chunk_attention", dname,
                {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "w": W,
                 "pos": pos},
                out, ring_chunk_attention_plain(q, kp, vp, table, kn, vn,
                                                pos, W),
                lambda: ring_chunk_attention(q, kp, vp, table, kn, vn, pos,
                                             W),
                lambda: ring_chunk_attention_plain(q, kp, vp, table, kn, vn,
                                                   pos, W),
                lambda: F.scaled_dot_product_attention(
                    qs, k_all, v_all, attn_mask=valid, enable_gqa=True),
                nbytes, flops,
                prev=(lambda: ring_chunk_attention(
                    q, kp, vp, table, kn, vn, pos, W, _body="cuda_core"))
                if body == "mma" else None,
                extra={"body": body, **_bounds(nbytes, flops, dname)}))

    # the attn layers' prefill at hd 256: bf16 on the wide mma body, timed
    # in turns against the previous cuda_core body, its bits the same in
    # blocks of 16, 32 and one dense block; float32 still on cuda_core
    max_len = GEMMA["max_len"]
    k_rows = rng.standard_normal((max_len, KV, HD)).astype(np.float32)
    v_rows = rng.standard_normal((max_len, KV, HD)).astype(np.float32)
    q_np = rng.standard_normal((C, H, HD)).astype(np.float32)
    layouts = {}
    for bs in (BS, 32, max_len):
        nb = max_len // bs
        table_np = (rng.permutation(nb) + 1).astype(np.int32)
        pools = []
        for rows in (k_rows, v_rows):
            pool = np.zeros((nb + 1, bs, KV, HD), np.float32)
            pool[table_np] = rows.reshape(nb, bs, KV, HD)
            pools.append(pool)
        layouts[bs] = pools + [table_np]
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        body = "mma" if dname == "bfloat16" else "cuda_core"
        kp, vp = (t(a, dtype) for a in layouts[BS][:2])
        table = torch.from_numpy(layouts[BS][2]).to(dev)
        q = t(q_np, dtype)
        for p0 in ((1024, 2048) if dname == "bfloat16" else (1024,)):
            out = _on_body("paged_prefill_attention", body,
                           lambda: paged_prefill_attention(q, kp, vp, table,
                                                           p0))
            if dname == "bfloat16":
                others = [paged_prefill_attention(
                    q, t(lay[0], dtype), t(lay[1], dtype),
                    torch.from_numpy(lay[2]).to(dev), p0)
                    for lay in (layouts[32], layouts[max_len])]
                equal = [torch.equal(out, o) for o in others]
                emit({"phase": "kernels", "kernel": "paged_prefill_attention",
                      "check": "hd 256: blocks of 32 and one dense block "
                               "bit-equal to blocks of 16", "dtype": dname,
                      "pos": p0, "blocks_equal": equal[0],
                      "dense_equal": equal[1]})
                if not all(equal):
                    raise AssertionError(f"paged_prefill_attention hd 256 pos "
                                         f"{p0}: blocks of 32 equal "
                                         f"{equal[0]}, one dense block equal "
                                         f"{equal[1]}")
            n_slots = p0 + C
            kc = paged_gather(kp, table[None])[0, :n_slots].permute(1, 0, 2)
            vc = paged_gather(vp, table[None])[0, :n_slots].permute(1, 0, 2)
            kc, vc = kc[None].contiguous(), vc[None].contiguous()
            qs = q.permute(1, 0, 2)[None].contiguous()
            cmask = (torch.arange(n_slots, device=dev)[None, :]
                     <= p0 + torch.arange(C, device=dev)[:, None])
            nbytes = (2 * C * H * HD * es + 2 * n_slots * KV * HD * es
                      + 4 * -(-n_slots // BS))
            flops = 4 * H * HD * sum(p0 + i + 1 for i in range(C))
            cases.append(_case(
                "paged_prefill_attention", dname,
                {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "pos": p0},
                out, paged_prefill_attention_plain(q, kp, vp, table, p0),
                lambda: paged_prefill_attention(q, kp, vp, table, p0),
                lambda: paged_prefill_attention_plain(q, kp, vp, table, p0),
                lambda: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=cmask, enable_gqa=True),
                nbytes, flops,
                prev=(lambda: paged_prefill_attention(
                    q, kp, vp, table, p0, _body="cuda_core"))
                if body == "mma" else None,
                extra={"body": body, **_bounds(nbytes, flops, dname)}))

    # ... and the decode kernels over linear rows and over rings (bf16 on
    # the wide mma body, against cuda_core in turns; the dense cache holds
    # the paged rows' own K/V, and the two kernels must give the same
    # bits), and over linear rows in float32 on cuda_core
    B = len(GEMMA_DECODE_POS)
    pos_np = np.asarray(GEMMA_DECODE_POS, np.int32)
    qd_np = rng.standard_normal((B, H, HD)).astype(np.float32)
    for dname, ring in (("bfloat16", False), ("bfloat16", True),
                        ("float32", False)):
        dtype = getattr(torch, dname)
        es = torch.finfo(dtype).bits // 8
        body = "mma" if dname == "bfloat16" else "cuda_core"
        qd = t(qd_np, dtype)
        s_len = W if ring else max_len
        kpos_np = np.minimum(pos_np, s_len - 1)   # the model's clamp
        pos = torch.from_numpy(kpos_np).to(dev)
        n_keys = int(kpos_np.sum() + B)
        mask = (torch.arange(s_len, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        nbs = s_len // BS
        nbp = B * nbs + 1
        kpool = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        vpool = t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
        tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(
            B, nbs) + 1).astype(np.int32)).to(dev)
        kc = paged_gather(kpool, tables).contiguous()     # (B, S, KV, hd)
        vc = paged_gather(vpool, tables).contiguous()
        kt = kc.permute(0, 2, 1, 3).contiguous()
        vt = vc.permute(0, 2, 1, 3).contiguous()
        shape = {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS,
                 "slots": s_len, "ring": ring, "pos": pos_np.tolist(),
                 "kernel_pos": kpos_np.tolist()}
        paged = _on_body("paged_decode_attention", body,
                         lambda: paged_decode_attention(qd, kpool, vpool,
                                                        tables, pos))
        dense = _on_body("dense_decode_attention", body,
                         lambda: dense_decode_attention(qd, kc, vc, pos))
        equal = torch.equal(paged, dense)
        emit({"phase": "kernels", "kernel": "dense_decode_attention",
              "check": "hd 256: dense bit-equal to paged on the same rows",
              "dtype": dname, "ring": ring, "equal": equal})
        if not equal:
            raise AssertionError(f"decode hd 256 {dname} ring {ring}: the "
                                 f"dense kernel's bits differ from the "
                                 f"paged kernel's")
        nbytes_paged = (2 * B * H * HD * es + 2 * n_keys * KV * HD * es
                        + 4 * (n_keys // BS + B) + 4 * B)
        nbytes_dense = 2 * B * H * HD * es + 2 * n_keys * KV * HD * es + 4 * B
        flops = 4 * H * HD * n_keys
        cases.append(_case(
            "paged_decode_attention", dname, shape, paged,
            paged_decode_attention_plain(qd, kpool, vpool, tables, pos),
            lambda: paged_decode_attention(qd, kpool, vpool, tables, pos),
            lambda: paged_decode_attention_plain(qd, kpool, vpool, tables,
                                                 pos),
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes_paged, flops,
            prev=(lambda: paged_decode_attention(
                qd, kpool, vpool, tables, pos, _body="cuda_core"))
            if body == "mma" else None, extra={"body": body}))
        cases.append(_case(
            "dense_decode_attention", dname, {**shape, "S": s_len}, dense,
            dense_decode_attention_plain(qd, kc, vc, pos),
            lambda: dense_decode_attention(qd, kc, vc, pos),
            lambda: dense_decode_attention_plain(qd, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes_dense, flops,
            prev=(lambda: dense_decode_attention(qd, kc, vc, pos,
                                                 _body="cuda_core"))
            if body == "mma" else None, extra={"body": body}))
    return cases


#: mixtral-8x7b's attention: 32 query heads over 8 KV heads of 128, a
#: ring of w = 4096 slots (every layer ``swa``), chunks of 128, rows of
#: max_len 4480 (prompts up to 4400 and 64 new tokens)
MIXTRAL = {"H": 32, "KV": 8, "hd": 128, "w": 4096, "C": 128, "max_len": 4480}
#: a decode batch's positions, 5-4470: before, at and past the ring's wrap
MIXTRAL_DECODE_POS = [5, 1000, 2047, 4094, 4095, 4096, 4300, 4470]


def mixtral_cases(dev) -> list:
    """The attention kernels at mixtral-8x7b's shapes, bf16, as its serve
    runs launch them: the window form (C 128 queries over the ring of 4096
    slots plus the chunk's keys) at pos 0, 2048 and 4300 (wrapped) on
    ``ring_body``'s ``wgmma`` (its bits the same in blocks of 32, as a
    dense ring and at a device pos; the ``mma`` body in turns), and the
    paged and dense decode on ``mma`` over rings of 4096 slots
    (B 8, pos 5-4470, at the pos the model clamps to w - 1; the dense
    kernel bit-equal to the paged one on the same rows), each against
    its plain version, SDPA and the bound.  rmsnorm's 8 and 128 rows of
    4096 are falcon-mamba-7b's cases in ``kernel_cases``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.flash_attention import (
        ring_body, ring_chunk_attention, ring_chunk_attention_plain,
        ring_positions, ring_splits)
    rng = np.random.default_rng(SEED + 13)
    H, KV, HD, W, C = (MIXTRAL[k] for k in ("H", "KV", "hd", "w", "C"))
    BS, dtype, es, cases = 16, torch.bfloat16, 2, []
    model = {"model": "mixtral-8x7b", "body": "mma"}
    body = ring_body(dtype, HD)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    nb = W // BS
    for pos in (0, 2048, 4300):
        table_np = (rng.permutation(nb) + 1).astype(np.int32)
        kp, vp = (t(rng.standard_normal((nb + 1, BS, KV, HD)))
                  for _ in range(2))
        table = torch.from_numpy(table_np).to(dev)
        q = t(rng.standard_normal((C, H, HD)))
        kn, vn = (t(rng.standard_normal((C, KV, HD))) for _ in range(2))
        out = ring_bits(dev, "mixtral-8x7b", q, kp, vp, table, kn, vn, pos,
                        W)
        kpos = ring_positions(pos, W, C, dev)[None, :]
        qpos = pos + torch.arange(C, device=dev)[:, None]
        valid = (kpos >= 0) & (kpos <= qpos) & (kpos > qpos - W)
        k_all = torch.cat([paged_gather(kp, table[None])[0], kn])
        v_all = torch.cat([paged_gather(vp, table[None])[0], vn])
        k_all = k_all.permute(1, 0, 2)[None].contiguous()
        v_all = v_all.permute(1, 0, 2)[None].contiguous()
        qs = q.permute(1, 0, 2)[None].contiguous()
        n_old = min(pos, W)
        nbytes = (2 * C * H * HD * es + 2 * (n_old + C) * KV * HD * es
                  + 4 * -(-n_old // BS))
        flops = 4 * HD * H * int(valid.sum())
        cases.append(_case(
            "ring_chunk_attention", "bfloat16",
            {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "w": W,
             "pos": pos},
            out, ring_chunk_attention_plain(q, kp, vp, table, kn, vn, pos, W),
            lambda: ring_chunk_attention(q, kp, vp, table, kn, vn, pos, W),
            lambda: ring_chunk_attention_plain(q, kp, vp, table, kn, vn, pos,
                                               W),
            lambda: F.scaled_dot_product_attention(
                qs, k_all, v_all, attn_mask=valid, enable_gqa=True),
            nbytes, flops,
            prev=lambda: ring_chunk_attention(q, kp, vp, table, kn, vn, pos,
                                              W, _body=_turn_body(body)),
            extra={**model, "body": body, "prev_body": _turn_body(body),
                   "splits": ring_splits(C, H, KV, HD, W, body),
                   **_bounds(nbytes, flops, "bfloat16")}))

    B = len(MIXTRAL_DECODE_POS)
    pos_np = np.minimum(np.asarray(MIXTRAL_DECODE_POS, np.int32), W - 1)
    pos = torch.from_numpy(pos_np).to(dev)
    qd = t(rng.standard_normal((B, H, HD)))
    nbp = B * nb + 1
    kpool, vpool = (t(rng.standard_normal((nbp, BS, KV, HD)))
                    for _ in range(2))
    tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(B, nb) + 1
                               ).astype(np.int32)).to(dev)
    kc = paged_gather(kpool, tables).contiguous()          # (B, W, KV, hd)
    vc = paged_gather(vpool, tables).contiguous()
    kt = kc.permute(0, 2, 1, 3).contiguous()
    vt = vc.permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(W, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    paged = _on_body("paged_decode_attention", "mma",
                     lambda: paged_decode_attention(qd, kpool, vpool, tables,
                                                    pos))
    dense = _on_body("dense_decode_attention", "mma",
                     lambda: dense_decode_attention(qd, kc, vc, pos))
    equal = torch.equal(paged, dense)
    emit({"phase": "kernels", "kernel": "dense_decode_attention",
          "check": "mixtral ring: dense bit-equal to paged on the same rows",
          "dtype": "bfloat16", "equal": equal})
    if not equal:
        raise AssertionError("decode over mixtral's ring: the dense "
                             "kernel's bits differ from the paged kernel's")
    n_keys = int(pos_np.sum() + B)
    shape = {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS, "slots": W,
             "ring": True, "pos": MIXTRAL_DECODE_POS,
             "kernel_pos": pos_np.tolist()}
    flops = 4 * H * HD * n_keys
    for name, out, kernel, plain, args, nbytes in (
            ("paged_decode_attention", paged, paged_decode_attention,
             paged_decode_attention_plain, (qd, kpool, vpool, tables, pos),
             2 * B * H * HD * es + 2 * n_keys * KV * HD * es
             + 4 * (n_keys // BS + B) + 4 * B),
            ("dense_decode_attention", dense, dense_decode_attention,
             dense_decode_attention_plain, (qd, kc, vc, pos),
             2 * B * H * HD * es + 2 * n_keys * KV * HD * es + 4 * B)):
        cases.append(_case(
            name, "bfloat16", shape, out, plain(*args),
            functools.partial(kernel, *args), functools.partial(plain, *args),
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes, flops, extra=dict(model)))
    return cases


#: zamba2-7b's shared attn block: 32 query heads over 32 KV heads (MHA,
#: G 1) of 112, chunks of 128, rows of max_len 2176 (prompts up to 2048
#: and 64 new tokens)
ZAMBA = {"H": 32, "KV": 32, "hd": 112, "C": 128, "max_len": 2176}
#: a decode batch's positions over the linear rows, 5-2175
ZAMBA_DECODE_POS = [5, 300, 1023, 1024, 1500, 1777, 2000, 2175]


def zamba_cases(dev) -> list:
    """The attention kernels at zamba2-7b's shared block (hd 112, G 1),
    bf16, as its serve runs launch them: the paged prefill (C 128 at pos
    0, 1024 and 2048) on ``chunk_body``'s ``wgmma`` (its bits the same in
    blocks of 32, one dense block and a batched launch at a device pos;
    the ``mma`` body in turns), and on ``mma`` the paged and dense decode over
    linear rows of 2176 slots (B 8, pos 5-2175; the dense kernel's bits
    the paged one's on the same rows), each against its plain version,
    SDPA and both halves of the bound.  The scan at d_state 64 is in
    ``scan_cases``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.flash_attention import (
        chunk_body, chunk_splits, paged_prefill_attention,
        paged_prefill_attention_plain)
    rng = np.random.default_rng(SEED + 14)
    H, KV, HD, C, L = (ZAMBA[k] for k in ("H", "KV", "hd", "C", "max_len"))
    BS, dtype, es, cases = 16, torch.bfloat16, 2, []
    model = {"model": "zamba2-7b", "body": "mma"}
    body = chunk_body(dtype, HD)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    nb = L // BS
    kp, vp = (t(rng.standard_normal((nb + 1, BS, KV, HD))) for _ in range(2))
    table = torch.from_numpy((rng.permutation(nb) + 1).astype(np.int32)).to(
        dev)
    q = t(rng.standard_normal((C, H, HD)))
    qs = q.permute(1, 0, 2)[None].contiguous()
    for p0 in (0, 1024, 2048):
        out = chunk_bits(dev, "zamba2-7b", q, kp, vp, table, p0)
        n_slots = p0 + C
        kc = paged_gather(kp, table[None])[0, :n_slots].permute(1, 0, 2)
        vc = paged_gather(vp, table[None])[0, :n_slots].permute(1, 0, 2)
        kc, vc = kc[None].contiguous(), vc[None].contiguous()
        cmask = (torch.arange(n_slots, device=dev)[None, :]
                 <= p0 + torch.arange(C, device=dev)[:, None])
        nbytes = (2 * C * H * HD * es + 2 * n_slots * KV * HD * es
                  + 4 * -(-n_slots // BS))
        flops = 4 * H * HD * sum(p0 + i + 1 for i in range(C))
        cases.append(_case(
            "paged_prefill_attention", "bfloat16",
            {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "pos": p0},
            out, paged_prefill_attention_plain(q, kp, vp, table, p0),
            lambda: paged_prefill_attention(q, kp, vp, table, p0),
            lambda: paged_prefill_attention_plain(q, kp, vp, table, p0),
            lambda: F.scaled_dot_product_attention(qs, kc, vc,
                                                   attn_mask=cmask),
            nbytes, flops,
            prev=lambda: paged_prefill_attention(q, kp, vp, table, p0,
                                                 _body=_turn_body(body)),
            extra={**model, "body": body, "prev_body": _turn_body(body),
                   "splits": chunk_splits(C, H, KV, HD, L),
                   **_bounds(nbytes, flops, "bfloat16")}))

    B = len(ZAMBA_DECODE_POS)
    pos_np = np.asarray(ZAMBA_DECODE_POS, np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    qd = t(rng.standard_normal((B, H, HD)))
    nbp = B * nb + 1
    kpool, vpool = (t(rng.standard_normal((nbp, BS, KV, HD)))
                    for _ in range(2))
    tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(B, nb) + 1
                               ).astype(np.int32)).to(dev)
    kc = paged_gather(kpool, tables).contiguous()          # (B, L, KV, hd)
    vc = paged_gather(vpool, tables).contiguous()
    kt = kc.permute(0, 2, 1, 3).contiguous()
    vt = vc.permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(L, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    paged = _on_body("paged_decode_attention", "mma",
                     lambda: paged_decode_attention(qd, kpool, vpool, tables,
                                                    pos))
    dense = _on_body("dense_decode_attention", "mma",
                     lambda: dense_decode_attention(qd, kc, vc, pos))
    equal = torch.equal(paged, dense)
    emit({"phase": "kernels", "kernel": "dense_decode_attention",
          "check": "zamba2 hd 112: dense bit-equal to paged on the same rows",
          "dtype": "bfloat16", "equal": equal})
    if not equal:
        raise AssertionError("decode at zamba2's hd 112: the dense kernel's "
                             "bits differ from the paged kernel's")
    n_keys = int(pos_np.sum() + B)
    shape = {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS, "slots": L,
             "pos": ZAMBA_DECODE_POS}
    flops = 4 * H * HD * n_keys
    for name, out, kernel, plain, args, nbytes in (
            ("paged_decode_attention", paged, paged_decode_attention,
             paged_decode_attention_plain, (qd, kpool, vpool, tables, pos),
             2 * B * H * HD * es + 2 * n_keys * KV * HD * es
             + 4 * (n_keys // BS + B) + 4 * B),
            ("dense_decode_attention", dense, dense_decode_attention,
             dense_decode_attention_plain, (qd, kc, vc, pos),
             2 * B * H * HD * es + 2 * n_keys * KV * HD * es + 4 * B)):
        cases.append(_case(
            name, "bfloat16", shape, out, plain(*args),
            functools.partial(kernel, *args), functools.partial(plain, *args),
            lambda: F.scaled_dot_product_attention(qd[:, :, None], kt, vt,
                                                   attn_mask=mask),
            nbytes, flops, extra={**model, **_bounds(nbytes, flops,
                                                     "bfloat16")}))
    return cases


#: the cross reads of the two cross-attention families: seamless-m4t-medium's
#: enc_xattn (16 / 16 heads of 64 over the encoder's 1024 frames) and
#: llama-3.2-vision-90b's xattn (64 / 8 heads of 128 over 1601 image
#: patches, 1601 = 100 x 16 + 1)
CROSS_SHAPES = {"seamless-m4t-medium": {"H": 16, "KV": 16, "hd": 64,
                                        "src": 1024},
                "llama-3.2-vision-90b": {"H": 64, "KV": 8, "hd": 128,
                                         "src": 1601}}
#: llama-3.2-vision-90b's self-attention layers (hd 128, G 8): the first
#: linear attn layers the port serves at hd 128
VISION = {"H": 64, "KV": 8, "hd": 128, "C": 128, "max_len": 1152}


def cross_cases(dev) -> list:
    """The kernels of the cross-attention families' cross reads, bf16 on
    ``wgmma`` for the cross form and ``mma`` for the decodes (float32 on
    ``cuda_core`` at one shape each): the flash kernel's cross form
    (``paged_cross_attention``: C 128 queries over every source slot, a
    chunk's B 1 through shuffled cross tables and ``Model.prefill``'s B 8
    through identity tables over dense rows, whose bits must equal the
    paged read's; the previous ``mma`` body gated and timed in turns, and
    the split ``cross_splits`` names printed), and the paged and dense
    decode at
    pos src - 1 (B 8; the dense kernel's bits the paged one's), each
    against its plain version, SDPA over the gathered K/V and both
    halves of the bound; then the paged prefill at llama-3.2-vision-90b's
    attn layers (C 128, 64 / 8 heads of 128, pos 0 and 1024) on
    ``chunk_body``'s ``wgmma`` (its bits the same in blocks of 32, one
    dense block and a batched launch at a device pos; ``mma`` in
    turns)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_plain,
        paged_decode_attention, paged_decode_attention_plain, paged_gather)
    from repro_torch.kernels.flash_attention import (
        chunk_body, chunk_splits, cross_body, cross_splits,
        paged_cross_attention, paged_cross_attention_plain,
        paged_prefill_attention, paged_prefill_attention_plain)
    rng = np.random.default_rng(SEED + 17)
    BS, C, cases = 16, 128, []

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    for model, sh in CROSS_SHAPES.items():
        H, KV, HD, src = sh["H"], sh["KV"], sh["hd"], sh["src"]
        nb = -(-src // BS)
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            es = torch.finfo(dtype).bits // 8
            body = "wgmma" if dname == "bfloat16" else "cuda_core"
            if cross_body(dtype, HD) != body:
                raise AssertionError(f"cross form {model} {dname}: "
                                     f"cross_body names "
                                     f"{cross_body(dtype, HD)}, expected "
                                     f"{body}")
            extra = {"model": model, "body": body,
                     "splits": cross_splits(C, H, KV, HD, src)
                     if body == "wgmma" else 1}
            for B in ((1, 8) if dname == "bfloat16" else (1,)):
                nbp = B * nb + 1
                kp, vp = (t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
                          for _ in range(2))
                tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(
                    B, nb) + 1).astype(np.int32)).to(dev)
                q = t(rng.standard_normal((B, C, H, HD)), dtype)
                kd = paged_gather(kp, tables)[:, :src].contiguous()
                vd = paged_gather(vp, tables)[:, :src].contiguous()
                out = _on_body("paged_cross_attention", body,
                               lambda: paged_cross_attention(
                                   q, kp, vp, tables, src))
                ident = torch.arange(B, dtype=torch.int32,
                                     device=dev)[:, None]
                dense = paged_cross_attention(q, kd, vd, ident, src)
                equal = torch.equal(dense, out)
                emit({"phase": "kernels", "kernel": "paged_cross_attention",
                      "check": "dense rows through identity tables "
                               "bit-equal to the paged read",
                      "model": model, "dtype": dname, "B": B,
                      "equal": equal})
                if not equal:
                    raise AssertionError(f"cross form {model} {dname} B {B}: "
                                         f"dense rows give other bits than "
                                         f"the paged read")
                qs = q.transpose(1, 2).contiguous()
                kt = kd.transpose(1, 2).contiguous()
                vt = vd.transpose(1, 2).contiguous()
                nbytes = (2 * B * C * H * HD * es + 2 * B * src * KV * HD * es
                          + 4 * B * nb)
                flops = 4 * B * C * H * HD * src
                prev = prev_out = None
                if body == "wgmma":
                    # the previous body, gated and timed in turns
                    prev_out = _on_body(
                        "paged_cross_attention", "mma",
                        lambda: paged_cross_attention(q, kp, vp, tables, src,
                                                      _body="mma"))

                    def prev():
                        return paged_cross_attention(q, kp, vp, tables, src,
                                                     _body="mma")
                cases.append(_case(
                    "paged_cross_attention", dname,
                    {"B": B, "C": C, "H": H, "KV": KV, "hd": HD, "bs": BS,
                     "src": src}, out,
                    paged_cross_attention_plain(q, kp, vp, tables, src),
                    lambda: paged_cross_attention(q, kp, vp, tables, src),
                    lambda: paged_cross_attention_plain(q, kp, vp, tables,
                                                        src),
                    lambda: F.scaled_dot_product_attention(
                        qs, kt, vt, enable_gqa=True),
                    nbytes, flops, prev=prev, prev_out=prev_out,
                    extra={**extra, **_bounds(nbytes, flops, dname)}))
                del kp, vp, kd, vd, q, qs, kt, vt, out, dense, prev, prev_out
        # the decode kernels at pos src - 1: every slot visible, the last
        # block's tail masked
        dtype, dname, es, B = torch.bfloat16, "bfloat16", 2, 8
        nbp = B * nb + 1
        kp, vp = (t(rng.standard_normal((nbp, BS, KV, HD)), dtype)
                  for _ in range(2))
        tables = torch.from_numpy((rng.permutation(nbp - 1).reshape(B, nb)
                                   + 1).astype(np.int32)).to(dev)
        kd = paged_gather(kp, tables)[:, :src].contiguous()
        vd = paged_gather(vp, tables)[:, :src].contiguous()
        pos = torch.full((B,), src - 1, dtype=torch.int32, device=dev)
        qd = t(rng.standard_normal((B, H, HD)), dtype)
        paged = _on_body("paged_decode_attention", "mma",
                         lambda: paged_decode_attention(qd, kp, vp, tables,
                                                        pos))
        dense = _on_body("dense_decode_attention", "mma",
                         lambda: dense_decode_attention(qd, kd, vd, pos))
        equal = torch.equal(paged, dense)
        emit({"phase": "kernels", "kernel": "dense_decode_attention",
              "check": f"{model} cross read: dense bit-equal to paged",
              "dtype": dname, "equal": equal})
        if not equal:
            raise AssertionError(f"cross decode at {model}: the dense "
                                 f"kernel's bits differ from the paged one's")
        kt = kd.transpose(1, 2).contiguous()
        vt = vd.transpose(1, 2).contiguous()
        shape = {"B": B, "H": H, "KV": KV, "hd": HD, "bs": BS, "src": src,
                 "pos": src - 1, "cross": True}
        flops = 4 * H * HD * B * src
        for name, got, kernel, plain, args, nbytes in (
                ("paged_decode_attention", paged, paged_decode_attention,
                 paged_decode_attention_plain, (qd, kp, vp, tables, pos),
                 2 * B * H * HD * es + 2 * B * src * KV * HD * es
                 + 4 * B * nb + 4 * B),
                ("dense_decode_attention", dense, dense_decode_attention,
                 dense_decode_attention_plain, (qd, kd, vd, pos),
                 2 * B * H * HD * es + 2 * B * src * KV * HD * es + 4 * B)):
            cases.append(_case(
                name, dname, shape, got, plain(*args),
                functools.partial(kernel, *args),
                functools.partial(plain, *args),
                lambda: F.scaled_dot_product_attention(
                    qd[:, :, None], kt, vt, enable_gqa=True),
                nbytes, flops, extra={"model": model, "body": "mma",
                                      **_bounds(nbytes, flops, dname)}))
        del kp, vp, kd, vd, kt, vt, paged, dense
    # the paged prefill at llama-3.2-vision-90b's attn layers: hd 128,
    # G 8, C 128 at pos 0 and 1024 (prompts of 256-1024 tokens)
    H, KV, HD, L = (VISION[k] for k in ("H", "KV", "hd", "max_len"))
    dtype, es, nb = torch.bfloat16, 2, L // BS
    kp, vp = (t(rng.standard_normal((nb + 1, BS, KV, HD)), dtype)
              for _ in range(2))
    table = torch.from_numpy((rng.permutation(nb) + 1).astype(np.int32)).to(
        dev)
    q = t(rng.standard_normal((C, H, HD)), dtype)
    qs = q.permute(1, 0, 2)[None].contiguous()
    body = chunk_body(dtype, HD)
    for p0 in (0, 1024):
        out = chunk_bits(dev, "llama-3.2-vision-90b", q, kp, vp, table, p0)
        n_slots = p0 + C
        kc = paged_gather(kp, table[None])[0, :n_slots].permute(1, 0, 2)
        vc = paged_gather(vp, table[None])[0, :n_slots].permute(1, 0, 2)
        kc, vc = kc[None].contiguous(), vc[None].contiguous()
        cmask = (torch.arange(n_slots, device=dev)[None, :]
                 <= p0 + torch.arange(C, device=dev)[:, None])
        nbytes = (2 * C * H * HD * es + 2 * n_slots * KV * HD * es
                  + 4 * -(-n_slots // BS))
        flops = 4 * H * HD * sum(p0 + i + 1 for i in range(C))
        cases.append(_case(
            "paged_prefill_attention", "bfloat16",
            {"C": C, "H": H, "KV": KV, "hd": HD, "bs": BS, "pos": p0},
            out, paged_prefill_attention_plain(q, kp, vp, table, p0),
            lambda: paged_prefill_attention(q, kp, vp, table, p0),
            lambda: paged_prefill_attention_plain(q, kp, vp, table, p0),
            lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=cmask, enable_gqa=True),
            nbytes, flops,
            prev=lambda: paged_prefill_attention(q, kp, vp, table, p0,
                                                 _body=_turn_body(body)),
            extra={"model": "llama-3.2-vision-90b", "body": body,
                   "prev_body": _turn_body(body),
                   "splits": chunk_splits(C, H, KV, HD, L),
                   **_bounds(nbytes, flops, "bfloat16")}))
    return cases


def _on_body(kernel: str, body: str, fn):
    """``fn()``, which must launch ``kernel`` once, on ``body``."""
    from repro_torch.kernels import _build
    before = dict(_build.bodies[kernel])
    out = fn()
    want = {k: n + (k == body) for k, n in before.items()}
    if _build.bodies[kernel] != want:
        raise AssertionError(f"{kernel}: launches by body went from "
                             f"{before} to {_build.bodies[kernel]}, expected "
                             f"one on {body}")
    return out


def _turn_body(body: str) -> str:
    """The body a two-tensor-core-body case (a chunk form's, a quant
    matmul's) times in turns against the rule's: the previous ``mma``
    where the rule names ``wgmma``, else ``wgmma``."""
    return "mma" if body == "wgmma" else "wgmma"


def chunk_bits(dev, label, q, kp, vp, table, pos):
    """The one-row paged chunk at host ``pos`` on its rule's body, whose
    bits the same logical rows in blocks of 32 and as one dense block must
    give, and so must a batched launch of the row with its pos read on
    the device; a line says which held.  Returns the output."""
    import torch
    from repro_torch.kernels.decode_attention import paged_gather
    from repro_torch.kernels.flash_attention import (chunk_body,
                                                     paged_chunk_attention,
                                                     paged_prefill_attention)
    body = chunk_body(q.dtype, q.shape[-1])
    out = _on_body("paged_prefill_attention", body,
                   lambda: paged_prefill_attention(q, kp, vp, table, pos))
    kr, vr = (paged_gather(pl, table[None])[0] for pl in (kp, vp))
    n, kv, hd = kr.shape
    t32 = torch.arange(n // 32, dtype=torch.int32, device=dev)
    eq = {"blocks_32": torch.equal(out, paged_prefill_attention(
              q, kr.reshape(-1, 32, kv, hd), vr.reshape(-1, 32, kv, hd),
              t32, pos)),
          "dense": torch.equal(out, paged_prefill_attention(
              q, kr[None], vr[None], t32[:1], pos)),
          "batched_device_pos": torch.equal(out, paged_chunk_attention(
              q[None], kp, vp, table[None],
              torch.tensor([pos], dtype=torch.int32, device=dev))[0])}
    emit({"phase": "kernels", "kernel": "paged_prefill_attention",
          "check": "blocks of 32, one dense block and a batched launch "
                   "(pos on the device) bit-equal to blocks of 16",
          "model": label, "body": body, "pos": pos, **eq})
    if not all(eq.values()):
        raise AssertionError(f"paged chunk {label} pos {pos} on {body}: "
                             f"bit-equality {eq}")
    return out


def ring_bits(dev, label, q, kp, vp, table, kn, vn, pos, w):
    """The window form at host ``pos`` on its rule's body, whose bits the
    same ring in blocks of 32 and as one dense block of ``w`` slots must
    give, and so must pos as a (1,) int32 tensor on the card; a line says
    which held.  Returns the output."""
    import torch
    from repro_torch.kernels.decode_attention import paged_gather
    from repro_torch.kernels.flash_attention import (ring_body,
                                                     ring_chunk_attention)
    body = ring_body(q.dtype, q.shape[-1])
    out = _on_body("ring_chunk_attention", body,
                   lambda: ring_chunk_attention(q, kp, vp, table, kn, vn,
                                                pos, w))
    kr, vr = (paged_gather(pl, table[None])[0, :w] for pl in (kp, vp))
    kv, hd = kr.shape[1:]
    t32 = torch.arange(w // 32, dtype=torch.int32, device=dev)
    eq = {"blocks_32": torch.equal(out, ring_chunk_attention(
              q, kr.reshape(-1, 32, kv, hd), vr.reshape(-1, 32, kv, hd),
              t32, kn, vn, pos, w)),
          "dense": torch.equal(out, ring_chunk_attention(
              q, kr[None].contiguous(), vr[None].contiguous(), t32[:1], kn,
              vn, pos, w)),
          "device_pos": torch.equal(out, ring_chunk_attention(
              q, kp, vp, table, kn, vn,
              torch.tensor([pos], dtype=torch.int32, device=dev), w))}
    emit({"phase": "kernels", "kernel": "ring_chunk_attention",
          "check": "blocks of 32, a dense one-block ring and device pos "
                   "bit-equal to blocks of 16 at host pos",
          "model": label, "body": body, "pos": pos, **eq})
    if not all(eq.values()):
        raise AssertionError(f"window form {label} pos {pos} on {body}: "
                             f"bit-equality {eq}")
    return out


def launch_floor(dev) -> list:
    """The empty kernel's device time and time per back-to-back call, at
    one block and at the grid of the decode scan (8 rows of
    falcon-mamba-7b), in blocks of 128 threads: the least any launch of
    such a grid costs, beside which the kernels of a few microseconds
    are judged."""
    from repro_torch.kernels.launch_floor import empty
    from repro_torch.kernels.selective_scan import scan_blocks, scan_lanes
    rows = []
    for blocks in (1, scan_blocks(8, 8192, scan_lanes(8, 8192, 16))):
        empty(dev, blocks)
        row = {"phase": "kernels", "kernel": "empty",
               "check": "launch floor (no TPU kernel; not listed)",
               "blocks": blocks, "threads": 128,
               "ms": device_ms(lambda: empty(dev, blocks)),
               "call_ms": call_ms(lambda: empty(dev, blocks))}
        emit(row)
        rows.append(row)
    return rows


#: the selective scan's cases: (model, B, T, DI, DS, h updated in place,
#: the columns before B in the projection B and C are sliced from, or
#: None for contiguous B and C).  falcon-mamba-7b's decode step of 8 rows
#: and prefill chunk of 128 steps; a ragged case (DI and T off the
#: kernel's tiles, B and C column slices of x_proj's [dt_r | B | C]);
#: zamba2-7b's decode step and chunk at d_state 64 (Mamba2's B and C,
#: the two halves of bc_proj's output)
SCAN_CASES = (("falcon-mamba-7b", 8, 1, 8192, 16, True, None),
              ("falcon-mamba-7b", 1, 128, 8192, 16, True, None),
              ("ragged", 2, 100, 300, 8, False, 5),
              ("zamba2-7b", 8, 1, 7168, 64, True, 0),
              ("zamba2-7b", 1, 128, 7168, 64, True, 0))


def scan_cases(dev) -> list:
    """The selective scan in float32 at ``SCAN_CASES``' shapes, with the
    state updated in place where the model updates it.  The model's body
    (``state_lanes``) is timed in turns with the previous one
    (``cuda_core``), whose ``h_T`` it must equal bit for bit (at
    falcon-mamba-7b's d_state 16 the state_lanes launch is the code it
    was before d_state 64 was added: the staged rows stay 16 wide)."""
    import torch
    from repro_torch.kernels.selective_scan import (scan_lanes,
                                                    selective_scan,
                                                    selective_scan_plain)
    rng = np.random.default_rng(SEED + 4)
    cases = []
    for model, b, t, di, ds, aliased, lead in SCAN_CASES:
        strided = lead is not None
        def f32(shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev)
        dt = torch.nn.functional.softplus(f32((b, t, di)))
        x, h0 = f32((b, t, di)), f32((b, di, ds))
        bm, cm = f32((b, t, ds)), f32((b, t, ds))
        a_neg = -f32((di, ds)).abs()
        if strided:       # x_proj's [dt_r | B | C], bc_proj's [B | C]
            proj = torch.cat([f32((b, t, lead)), bm, cm], dim=-1)
            bm, cm = proj[..., lead:lead + ds], proj[..., lead + ds:]
        want_y, want_h = selective_scan_plain(dt, bm, cm, x, a_neg, h0)
        h, hp = h0.clone(), h0.clone()
        got_y, got_h = selective_scan(dt, bm, cm, x, a_neg, h,
                                      h_out=h if aliased else None)
        if aliased and got_h is not h:
            raise AssertionError("selective_scan: h_out=h0 did not update "
                                 "the state in place")
        prev_y, prev_h = selective_scan(dt, bm, cm, x, a_neg, hp,
                                        h_out=hp if aliased else None,
                                        _body="cuda_core")
        shape = {"model": model, "B": b, "T": t, "DI": di, "DS": ds,
                 "h_in_place": aliased, "strided_bc": strided,
                 "lanes": scan_lanes(b, di, ds)}
        h_equal = torch.equal(got_h, prev_h)
        emit({"phase": "kernels", "kernel": "selective_scan",
              "check": "h_T of state_lanes bit-equal to cuda_core's",
              "shape": shape, "equal": h_equal,
              "y_max_abs_diff": (got_y - prev_y).abs().max().item()})
        if not h_equal:
            raise AssertionError(f"selective_scan {shape}: state_lanes' h_T "
                                 f"differs from the previous body's")
        hs = h.clone()    # the timed calls carry this state on, in place

        def kernel(hs=hs, args=(dt, bm, cm, x, a_neg)):
            return selective_scan(*args, hs, h_out=hs if aliased else None)

        def prev(hs=hs, args=(dt, bm, cm, x, a_neg)):
            return selective_scan(*args, hs, h_out=hs if aliased else None,
                                  _body="cuda_core")

        def plain(hs=hs, args=(dt, bm, cm, x, a_neg)):
            return selective_scan_plain(*args, hs,
                                        h_out=hs if aliased else None)
        issue_ms = (b * t * di * ds * SCAN_INSTR_PER_UPDATE
                    / ISSUE_PER_S * 1e3)
        cases.append(_case(
            "selective_scan", "float32", shape,
            torch.cat([got_y.flatten(), got_h.flatten()]),
            torch.cat([want_y.flatten(), want_h.flatten()]),
            kernel, plain, None,
            # dt, x, y once per (b, t, d); B, C per (b, t); A once; h read
            # and written
            4 * (3 * b * t * di + 2 * b * t * ds + di * ds + 2 * b * di * ds),
            # per (b, t, d): dt*x, then per state element a multiply, an
            # exp, three more multiplies and two adds (an exp counted as
            # one f32 operation)
            b * t * di * (1 + 7 * ds),
            relative=True,
            library_note="none: no single PyTorch call computes the "
                         "recurrence",
            prev=prev, prev_out=torch.cat([prev_y.flatten(),
                                           prev_h.flatten()]),
            extra={"issue_bound_ms": issue_ms,
                   "instr_per_update": SCAN_INSTR_PER_UPDATE}))
    return cases


#: the scan's backward kernel at the train runs' shapes: (model, B, T,
#: DI, d_state, Mamba2's A and B / C slices)
SCAN_BWD_CASES = (("falcon-mamba-7b", 2, 2048, 8192, 16, False),
                  ("zamba2-7b", 2, 2048, 7168, 64, True))
#: operations a state element and step of the backward takes: the
#: recomputed forward update (dt*a, exp, decay*h, dx*B, the add) and the
#: backward's eighteen (dt*a, exp, C*dy, + the carried gradient, g*B and
#: its add, h_{t-1}*a_t, *A, x*B, the add, g*(...) and its add, g*(dt x),
#: h*dy, g*h_{t-1}*a_t, *dt and its add, a_t*g), an exp counted as one
SCAN_BWD_OPS = 23


def scan_train_inputs(dev, rng, b, t, di, ds, mamba2):
    """Scan inputs in the model's range (dt a softplus around the
    init's dt_bias of -2; A around Mamba1's -(1..d_state), or with
    ``mamba2`` one value a channel around Mamba2's init of -1 over
    d_state, B and C then column slices of one projection, as
    ``_mamba2_scan`` passes them) and the cotangent of y, float32 on the
    card."""
    import torch

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32)).to(dev)
    dt = torch.nn.functional.softplus(f32(b, t, di) - 2)
    if mamba2:
        a_neg = -torch.exp(0.3 * f32(di, 1)).expand(di, ds).contiguous()
    else:
        a_neg = -torch.exp(torch.log(torch.arange(
            1, ds + 1, device=dev, dtype=torch.float32)) + 0.3 * f32(di, ds))
    strided = mamba2
    bm, cm = f32(b, t, ds), f32(b, t, ds)
    if strided:       # bc_proj's [B | C]
        bc = torch.cat([bm, cm], dim=-1)
        bm, cm = bc[..., :ds], bc[..., ds:]
    return dt, bm, cm, f32(b, t, di), a_neg, f32(b, t, di)


def scan_backward_cases(dev) -> list:
    """The scan's training kernels in float32.  First the forward's
    checkpoint pointer: at falcon-mamba-7b's serving shapes (a decode
    step of 8 rows, a chunk of 128) the launch with checkpoints gives the
    bits of the launch without (y and h_T), and at ``SCAN_BWD_CASES``'
    train shapes both are timed in turns (without, with, with,
    without).  Then the backward kernel from those checkpoints against
    ``selective_scan_backward_plain`` (every gradient within 2e-5 of
    max(1, |plain|)), launched twice with the same bits, timed beside the
    plain version (one call: thousands of launches) and its bound, with
    its blocks an SM and shared memory from the occupancy calculator; no
    PyTorch call computes the scan's gradient (``tools/torch_scan_sweep.py
    --backward`` times it against the previous kernel)."""
    import torch
    from repro_torch.kernels.selective_scan import (
        bwd_occupancy, scan_checkpoints, selective_scan,
        selective_scan_backward, selective_scan_backward_plain)
    rng = np.random.default_rng(SEED + 30)
    for b, t, di, ds in ((8, 1, 8192, 16), (1, 128, 8192, 16)):
        dt, bm, cm, x, a_neg, _ = scan_train_inputs(dev, rng, b, t, di, ds,
                                                    False)
        h0 = torch.from_numpy(rng.standard_normal(
            (b, di, ds), dtype=np.float32)).to(dev)
        ckpt = torch.empty((b, scan_checkpoints(t), di, ds), device=dev)
        y0, h_0 = selective_scan(dt, bm, cm, x, a_neg, h0)
        y1, h_1 = selective_scan(dt, bm, cm, x, a_neg, h0, checkpoints=ckpt)
        equal = torch.equal(y0, y1) and torch.equal(h_0, h_1)
        shape = {"model": "falcon-mamba-7b", "B": b, "T": t, "DI": di,
                 "DS": ds}
        emit({"phase": "kernels", "kernel": "selective_scan",
              "check": "a serving launch with the checkpoint pointer: y "
                       "and h_T bit-equal to the launch without",
              "shape": shape, "equal": equal,
              "ckpt_equal_h0": torch.equal(ckpt[:, 0], h0)})
        if not (equal and torch.equal(ckpt[:, 0], h0)):
            raise AssertionError(f"selective_scan {shape}: the checkpoint "
                                 f"pointer changed the serving launch")
    cases = []
    for model, b, t, di, ds, mamba2 in SCAN_BWD_CASES:
        dt, bm, cm, x, a_neg, dy = scan_train_inputs(dev, rng, b, t, di, ds,
                                                     mamba2)
        h0 = torch.zeros((b, di, ds), device=dev)
        nc = scan_checkpoints(t)
        ckpt = torch.empty((b, nc, di, ds), device=dev)
        selective_scan(dt, bm, cm, x, a_neg, h0, checkpoints=ckpt)
        turns = [device_ms(f) for f in (
            lambda: selective_scan(dt, bm, cm, x, a_neg, h0),
            lambda: selective_scan(dt, bm, cm, x, a_neg, h0,
                                   checkpoints=ckpt),
            lambda: selective_scan(dt, bm, cm, x, a_neg, h0,
                                   checkpoints=ckpt),
            lambda: selective_scan(dt, bm, cm, x, a_neg, h0))]
        blocks, smem = bwd_occupancy(ds)
        fwd = {"forward_ms": (turns[0] + turns[3]) / 2,
               "forward_ckpt_ms": (turns[1] + turns[2]) / 2,
               "forward_turns_ms": turns, "backward_blocks_per_sm": blocks,
               "backward_smem": smem}
        args = (dt, bm, cm, x, a_neg, ckpt, dy)
        want = selective_scan_backward_plain(*args)
        got = selective_scan_backward(*args)
        again = selective_scan_backward(*args)
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        shape = {"model": model, "B": b, "T": t, "DI": di, "DS": ds,
                 "mamba2": mamba2, "checkpoints": nc}
        emit({"phase": "kernels", "kernel": "selective_scan_backward",
              "check": "two launches, the same bits", "shape": shape,
              "equal": same, **fwd})
        if not same:
            raise AssertionError(f"selective_scan_backward {shape}: two "
                                 f"launches differ")
        nbytes = 4 * (5 * b * t * di + 4 * b * t * ds + 2 * di * ds
                      + b * nc * di * ds + b * di * ds)
        cases.append(_case(
            "selective_scan_backward", "float32", shape,
            torch.cat([g.flatten() for g in got]),
            torch.cat([w.flatten() for w in want]),
            lambda args=args: selective_scan_backward(*args),
            lambda args=args: selective_scan_backward_plain(*args), None,
            nbytes, b * t * di * (3 + SCAN_BWD_OPS * ds), relative=True,
            library_note="none: no PyTorch call computes the scan's "
                         "gradient", extra=fwd, plain_calls=1))
    return cases


#: CrossAttentionFn's forward at the train runs' cross reads: (label, B,
#: C queries, H, KV, hd, src)
CROSS_FN_CASES = (("llama-3.2-vision-90b", 2, 512, 64, 8, 128, 1601),
                  ("seamless-m4t-medium", 2, 512, 16, 16, 64, 1024))


def cross_fn_cases(dev) -> list:
    """``CrossAttentionFn``'s forward at the train runs' cross reads in
    bf16: the cross form itself over identity tables (bit for bit, one
    launch on the wgmma body), and the torch-op backward's device time
    beside the forward's (it runs under the profiler label
    ``cross_attention_backward`` in a train step)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        CrossAttentionFn, cross_attention_backward, paged_cross_attention)
    rng = np.random.default_rng(SEED + 31)
    for label, b, c, h, kv, hd, src in CROSS_FN_CASES:
        def bf(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev, torch.bfloat16)
        q, k, v, dout = bf(b, c, h, hd), bf(b, src, kv, hd), bf(
            b, src, kv, hd), bf(b, c, h, hd)
        tables = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
        _build.reset_launches()
        got = CrossAttentionFn.apply(q, k, v)
        launched = dict(_build.bodies["paged_cross_attention"])
        want = paged_cross_attention(q, k, v, tables, src)
        equal = torch.equal(got, want)
        res = {"phase": "kernels", "kernel": "paged_cross_attention",
               "check": "CrossAttentionFn's forward = the cross form over "
                        "identity tables, bit for bit",
               "shape": {"model": label, "B": b, "C": c, "H": h, "KV": kv,
                         "hd": hd, "src": src}, "dtype": "bfloat16",
               "equal": equal, "bodies": launched,
               "forward_ms": device_ms(
                   lambda: paged_cross_attention(q, k, v, tables, src)),
               "backward_torch_ops_ms": device_ms(
                   lambda: cross_attention_backward(q, k, v, dout), n=3,
                   warmup=1)}
        emit(res)
        if not equal or launched.get("wgmma") != 1:
            raise AssertionError(f"CrossAttentionFn {res}: not the cross "
                                 f"form's wgmma launch")
    return []


# ---------------------------------------------------------------------------
# phases 4-5: the engine
# ---------------------------------------------------------------------------
def _to(params, dev):
    if isinstance(params, dict):
        return {k: _to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, dev) for v in params]
    return params if params is None else params.to(dev)


def _card_drawn(cfg, dev):
    """``cfg``'s parameters drawn on the card from the seed and copied to
    the CPU, where a parity cell's CPU side starts from them (the card's
    side copies them back): the same weights on both devices, drawn in a
    second where the CPU takes tens of seconds at full width."""
    import torch
    from repro_torch.models.model import Model
    params = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    return _to(params, torch.device("cpu"))


def _trace(rng, n, lo, hi, vocab):
    return [rng.integers(1, vocab, int(m)).tolist()
            for m in rng.integers(lo, hi + 1, n)]


def _top2_gap(model, params, tokens, dev):
    """Top-2 logit gap of the next token after ``tokens`` (plain path),
    the two tokens and the top logit."""
    import torch
    from repro_torch.models.kvcache import PagedCache
    max_len = max(1024, -(-(len(tokens) + 1) // 16) * 16)
    pc = PagedCache(model.cfg, max_rows=1, max_len=max_len, device=dev)
    caches = pc.struct(model.dtype)
    pc.admit(0, len(tokens))
    prompt = torch.tensor([tokens[:-1]], dtype=torch.int32, device=dev)
    if len(tokens) > 1:
        model.paged_prefill_chunk(params, caches, prompt, 0, 0, pc.meta(row=0))
    logits, _ = model.paged_decode_step(
        params, caches,
        {"token": torch.tensor([[tokens[-1]]], dtype=torch.int32, device=dev),
         "pos": torch.tensor([len(tokens) - 1], dtype=torch.int32,
                             device=dev)}, pc.meta())
    top = torch.topk(logits[0, -1, :model.cfg.vocab_size].float(), 2)
    return ((top.values[0] - top.values[1]).item(), top.indices.tolist(),
            top.values[0].item())


def _first_divergence(cfg, params_cpu, fmt, prompts, got_all, ref_all):
    """Where the card's stream first leaves the CPU's, with the plain
    path's top-2 logit gap there."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.models.quantize import quantize_params
    cpu = torch.device("cpu")
    for rid, ref in sorted(ref_all.items()):
        got = got_all.get(rid, [])
        if got != ref:
            i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                     min(len(got), len(ref)))
            gap, top, _ = _top2_gap(Model(cfg, qformat=fmt, device=cpu),
                                 quantize_params(params_cpu, fmt),
                                 prompts[rid] + ref[:i], cpu)
            return {"request": rid, "index": i, "cuda": got[i:i + 4],
                    "cpu": ref[i:i + 4], "plain_top2_gap": gap,
                    "plain_top2": top}
    return None


#: the monolithic engine each pipelined engine of the parity phase is
#: held to on the card
PIPE_OF = {"pipe_paged": "paged", "pipe_slot": "slot"}


def _parity_config(dev, cfg, label, runs, prompts, max_len, n_new=16,
                   params_cpu=None, draft_cfg=None,
                   cpu_all: bool = True) -> dict:
    """One trace (``n_new`` new tokens a request) through each (engine,
    format, speculation) of ``runs`` on the card and on the CPU, from the
    same f32 weights (``params_cpu``, else drawn from the seed on the
    CPU; each engine packs its own).  Engines: ``paged`` / ``slot`` (the monolithic engines) and
    ``pipe_paged`` / ``pipe_slot`` (``PagedPipelinedEngine`` /
    ``PipelinedEngine``, 2 stages).  Speculation is None, an int K (n-gram
    drafts) or ``"model"`` (a 2-layer smollm-360m draft at full width,
    float32, with weights from its own seed, drawn on the CPU so both
    devices hold the same; ``draft_cfg``, where given, in its place).
    Streams and ``t_*`` stamps must be equal.  A
    speculative run's card stream must also equal the card's
    non-speculative stream of the same engine and format, and a
    pipelined run's card streams and stamps the card's monolithic ones
    (``PIPE_OF``), which ``runs`` must hold before it.  A pipelined
    engine's stages are placed round-robin over a seeded edge network
    (``make_network``), so every stage boundary is a hop between two
    nodes: its simulated ``transfer_ms``, ``transfer_mb`` and hops must
    be equal on both devices and not empty.  ``cpu_all`` False skips the
    CPU's side of a run that the card already holds to a run checked
    against the CPU: a pipelined run (streams and stamps equal to the
    monolithic run's; its transfers then only held non-empty, each stage
    on its own node) and a speculative run that the card's engine gated
    off (streams and stamps equal to the plain run's)."""
    import torch
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            ServingEngine)
    from repro_torch.core.network import make_network
    from repro_torch.serving.pipeline import (PagedPipelinedEngine,
                                              PipelinedEngine, place_stages)
    from repro_torch.serving.speculative import ModelDraft
    cpu = torch.device("cpu")
    net = make_network(np.random.default_rng(SEED))
    if params_cpu is None:
        params_cpu = Model(cfg, device=cpu).init(
            torch.Generator().manual_seed(SEED))
    params_gpu = _to(params_cpu, dev)
    if draft_cfg is None:
        draft_cfg = dataclasses.replace(get_config("smollm-360m"),
                                        n_layers=2,
                                        block_pattern=uniform("attn", 2),
                                        dtype="float32")

    def speculative(spec, d):
        if spec == "model":
            return {"k": 4, "provider": ModelDraft(draft_cfg, seed=SEED + 7,
                                                   device=d)}
        return spec
    engines = {
        "paged": lambda p, d, fmt, spec: PagedServingEngine(
            cfg, p, max_rows=4, max_len=max_len, block_size=16,
            prefill_chunk=128, decode_steps=4, quantization=fmt,
            speculative=speculative(spec, d), device=d),
        "slot": lambda p, d, fmt, spec: ServingEngine(
            cfg, p, max_batch=4, cache_len=max_len, prefill_chunk=128,
            decode_steps=4, quantization=fmt,
            speculative=speculative(spec, d), device=d),
        "pipe_paged": lambda p, d, fmt, spec: PagedPipelinedEngine(
            cfg, p, n_stages=2, max_rows=4, max_len=max_len, block_size=16,
            prefill_chunk=128, decode_steps=4, quantization=fmt, net=net,
            speculative=speculative(spec, d), device=d),
        "pipe_slot": lambda p, d, fmt, spec: PipelinedEngine(
            cfg, p, n_stages=2, max_batch=4, cache_len=max_len,
            prefill_chunk=128, decode_steps=4, quantization=fmt, net=net,
            speculative=speculative(spec, d), device=d)}
    streams, stamps, transfer, results = {}, {}, {}, []
    t0 = time.perf_counter()
    for engine, fmt, spec in runs:
        transfer = {}
        for name, d, p in (("cuda", dev, params_gpu),
                           ("cpu", cpu, params_cpu)):
            if name == "cpu" and not cpu_all and (
                    engine in PIPE_OF
                    or (spec is not None and eng.spec_gated_off)):
                break                       # held on the card (see above)
            eng = engines[engine](p, d, fmt, spec)
            if engine in PIPE_OF:
                eng.set_placement(place_stages(
                    eng.to_application(np.random.default_rng(SEED)), net,
                    "round_robin"))
            for i, pr in enumerate(prompts):
                eng.submit(Request(i, list(pr), max_new_tokens=n_new))
            done = eng.run()
            if engine in PIPE_OF:
                transfer[name] = (eng.transfer_ms, eng.transfer_mb,
                                  {f"{a}->{b}": h
                                   for (a, b), h in eng.hops.items()})
            streams[engine, fmt, spec, name] = {r.id: r.out_tokens
                                                for r in done}
            stamps[engine, fmt, spec, name] = {
                r.id: (r.t_submit, r.t_admit, r.t_first, r.t_done)
                for r in done}
        got = streams[engine, fmt, spec, "cuda"]
        got_t = stamps[engine, fmt, spec, "cuda"]
        held = (engine, fmt, spec, "cpu") not in streams
        ref = got if held else streams[engine, fmt, spec, "cpu"]
        run = {"engine": engine, "quantization": fmt, "speculative": spec,
               "cpu_side": not held,
               "equal": held or (got == ref and got_t == stamps[
                   engine, fmt, spec, "cpu"]),
               "tokens": sum(len(x) for x in ref.values())}
        if spec is not None:
            plain = (engine, fmt, None, "cuda")
            run.update(
                equal_to_plain=got == streams[plain],
                spec_gated_off=eng.spec_gated_off,
                spec_rounds=eng.spec_rounds,
                acceptance_rate=eng.acceptance_rate,
                spec_accept_mean=eng.spec_accept_mean())
            if held:
                run["stamps_equal_to_plain"] = got_t == stamps[plain]
                run["equal_to_plain"] = (run["equal_to_plain"]
                                         and run["stamps_equal_to_plain"])
            run["equal"] = run["equal"] and run["equal_to_plain"]
        if engine in PIPE_OF:
            mono = (PIPE_OF[engine], fmt, spec, "cuda")
            run.update(stages=[(st.lo, st.hi) for st in eng.stages],
                       placement=eng.placement,
                       transfer_ms=transfer["cuda"][0],
                       transfer_mb=transfer["cuda"][1],
                       hops=transfer["cuda"][2],
                       transfer_equal=(transfer["cuda"] == transfer.get(
                                           "cpu", transfer["cuda"])
                                       and len(transfer["cuda"][2]) > 0
                                       and len(set(eng.placement.values()))
                                       == len(eng.stages)),
                       equal_to_monolithic=(got == streams[mono]
                                            and got_t == stamps[mono]))
            run["equal"] = (run["equal"] and run["equal_to_monolithic"]
                            and run["transfer_equal"])
        if got != ref:
            run["first_divergence"] = _first_divergence(
                cfg, params_cpu, fmt, prompts, got, ref)
        results.append(run)
    slot_is_paged = {str(fmt): streams["slot", fmt, None, "cuda"]
                     == streams["paged", fmt, None, "cuda"]
                     for engine, fmt, spec in runs
                     if engine == "slot" and spec is None}
    res = {"phase": "parity", "config": label,
           "requests": len(prompts), "runs": results,
           "card_slot_equals_paged": slot_is_paged,
           "equal": all(r["equal"] for r in results)
           and all(slot_is_paged.values()),
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not res["equal"]:
        raise AssertionError(f"{label}: token streams or stamps differ: "
                             f"card against CPU, slot against paged engine "
                             f"on the card, speculative against plain "
                             f"decode on the card, or pipelined against "
                             f"monolithic on the card (or its simulated "
                             f"transfers against the CPU's)")
    return res


def parity(dev) -> list:
    """smollm-360m through both engines, unquantized and quantized, and
    with speculation (n-gram drafts on both engines and with int8 weights,
    a model draft on the paged engine; K = 4), then falcon-mamba-7b and
    gemma3-12b (one ``swa`` layer with its published window of 1024, one
    ``attn``) through both engines and once with ``speculative=4``, which
    they must gate off; each at full width and 2 layers in float32, on
    the card and on the CPU.  gemma3's prompts (1040-1200 tokens) all
    wrap the ring before their first decode step.  Beyond smollm's cell,
    whose every run has its CPU side, the cells skip the CPU's side of
    the runs the card holds to another (``_parity_config``'s
    ``cpu_all``): the pipelined runs and the gated-off speculation.
    Then mixtral-8x7b (``mixtral_parity``)."""
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    smollm = dataclasses.replace(get_config("smollm-360m"), n_layers=2,
                                 block_pattern=uniform("attn", 2),
                                 dtype="float32")
    mamba = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2,
                                block_pattern=uniform("mamba1", 2),
                                dtype="float32")
    gemma = dataclasses.replace(get_config("gemma3-12b"), n_layers=2,
                                block_pattern=("swa", "attn"),
                                dtype="float32")
    smollm_res = _parity_config(
        dev, smollm, "smollm-360m, 2 layers, float32",
        (("paged", None, None), ("paged", "int8", None),
         ("paged", "int4", None), ("slot", None, None),
         ("slot", "int8", None), ("paged", None, 4), ("slot", None, 4),
         ("paged", "int8", 4), ("paged", None, "model"),
         ("pipe_paged", None, None), ("pipe_slot", None, None),
         ("pipe_paged", "int8", None), ("pipe_slot", "int8", None),
         ("pipe_paged", None, 4), ("pipe_slot", None, 4)),
        _trace(np.random.default_rng(SEED + 1), 4, 20, 150,
               smollm.vocab_size), 256, n_new=8)
    # prompts of at most 64 tokens keep the CPU's side short
    mamba_res = _parity_config(
        dev, mamba, "falcon-mamba-7b, 2 layers, float32",
        (("paged", None, None), ("slot", None, None), ("paged", None, 4),
         ("pipe_paged", None, None), ("pipe_slot", None, None)),
        _trace(np.random.default_rng(SEED + 5), 4, 20, 64,
               mamba.vocab_size), 128, n_new=8, cpu_all=False)
    # two prompts and 8 new tokens keep the CPU's side short (its head
    # over 262,144 rows in f32 is most of a decode step there)
    gemma_res = _parity_config(
        dev, gemma, "gemma3-12b, 2 layers (swa, attn), float32",
        (("paged", None, None), ("slot", None, None), ("paged", None, 4),
         ("pipe_paged", None, None), ("pipe_slot", None, None)),
        _trace(np.random.default_rng(SEED + 10), 2, 1030, 1100,
               gemma.vocab_size), 1280, n_new=8,
        params_cpu=_card_drawn(gemma, dev), cpu_all=False)
    spec_runs = [r for r in smollm_res["runs"] if r["speculative"]]
    gated = [r for res in (mamba_res, gemma_res) for r in res["runs"]
             if r["speculative"]]
    if (any(r["spec_gated_off"] or r["spec_rounds"] == 0 for r in spec_runs)
            or not all(r["spec_gated_off"] and r["spec_rounds"] == 0
                       for r in gated)):
        raise AssertionError(f"speculation: smollm runs {spec_runs} must "
                             f"speculate, falcon-mamba and gemma3 runs "
                             f"{gated} must gate it off")
    return [smollm_res, mamba_res, gemma_res, policy_parity(dev, smollm),
            *mixtral_parity(dev), zamba_parity(dev), *cross_parity(dev),
            *target_parity(dev)]


#: the speculation targets' parity runs: both engines with no draft, with
#: n-gram drafts and with a model draft, K 4
TARGET_RUNS = (("paged", None, None), ("slot", None, None),
               ("paged", None, 4), ("slot", None, 4),
               ("paged", None, "model"), ("slot", None, "model"))


def target_parity(dev) -> list:
    """qwen2-72b and command-r-35b at smoke size (2 layers of d_model 128,
    4 heads of 32, vocab 512, qwen2's QKV bias and rope theta 1e6,
    command-r's tied head and theta 8e6), float32: 4 prompts of 20-40
    tokens, 16 new tokens each, through ``TARGET_RUNS`` on the card and
    on the CPU; the model draft is the smoke smollm-360m (its own seed).
    Streams and stamps card = CPU, every speculative stream the same
    engine's plain one, and every speculative run speculates."""
    from repro_torch.configs import get_smoke_config
    out = []
    for i, arch in enumerate(("qwen2-72b", "command-r-35b")):
        cfg = get_smoke_config(arch)
        res = _parity_config(
            dev, cfg, f"{arch} smoke (2 layers, d_model 128), float32",
            TARGET_RUNS, _trace(np.random.default_rng(SEED + 40 + i), 4, 20,
                                40, cfg.vocab_size), 128,
            draft_cfg=get_smoke_config("smollm-360m"))
        idle = [r for r in res["runs"]
                if r["speculative"] and (r["spec_gated_off"]
                                         or r["spec_rounds"] == 0)]
        if idle:
            raise AssertionError(f"{arch}: speculative runs {idle} did not "
                                 f"speculate")
        out.append(res)
    return out


SEAMLESS, VISION_ARCH = "seamless-m4t-medium", "llama-3.2-vision-90b"
#: the cross-attention families' parity cells: full width, float32, 2
#: decoder layers; seamless-m4t-medium with 2 of its 12 encoder layers
#: (the serving engines never run the encoder: requests carry no
#: frontend), llama-3.2-vision-90b with one attn and one cross layer and
#: d_ff cut from 28672 to 4096 so the CPU's side stays short
CROSS_PARITY = {SEAMLESS: {"n_layers": 2, "block_pattern": ("attn", "attn"),
                           "n_encoder_layers": 2},
                VISION_ARCH: {"n_layers": 2,
                              "block_pattern": ("attn", "cross"),
                              "d_ff": 4096}}
#: Model.prefill then decode_steps in the parity cells: 2 prompts of 32
#: tokens with a seeded frontend, then 8 greedy tokens
PREFILL_PARITY = {"rows": 2, "prompt": 32, "new": 8}


def prefill_parity(dev, cfg, params_cpu, label) -> dict:
    """``Model.prefill`` of ``PREFILL_PARITY``'s prompts with a seeded
    frontend (image patches, or the encoder's frames) on the card and on
    the CPU from the same f32 weights, then ``decode_steps`` over the
    prefilled dense caches, whose cross K/V are real: the prefill's
    greedy token and the decoded stream must be equal on both devices,
    and the cross caches non-zero.  Prints the largest difference of the
    prefill logits."""
    import torch
    from repro_torch.models.model import Model
    cpu = torch.device("cpu")
    rows, s, new = (PREFILL_PARITY[k] for k in ("rows", "prompt", "new"))
    rng = np.random.default_rng(SEED + 21)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (rows, s))
                              .astype(np.int32))
    src = cfg.n_image_tokens or cfg.encoder_seq
    frontend = torch.from_numpy(rng.standard_normal(
        (rows, src, cfg.d_model), dtype=np.float32))
    t0 = time.perf_counter()
    out = {}
    for name, d, p in (("cuda", dev, _to(params_cpu, dev)),
                       ("cpu", cpu, params_cpu)):
        model = Model(cfg, device=d)
        logits, caches, _ = model.prefill(
            p, {"tokens": tokens.to(d), "frontend": frontend.to(d)}, s + new)
        first = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)
        toks = model.decode_steps(model.one_stage(p, caches), {
            "token": first[:, None],
            "pos": torch.full((rows,), s, dtype=torch.int32, device=d),
            "budget": torch.full((rows,), new, dtype=torch.int32,
                                 device=d)}, k=new)
        cross = sum(float(c[n].abs().sum()) for c in caches for n in c
                    if n in ("xk", "xv"))
        out[name] = (logits.float().cpu(), torch.cat(
            [first[:, None], toks], 1).cpu().tolist(), cross)
        del p, caches, logits
    res = {"phase": "parity", "config": label,
           "path": "Model.prefill with a seeded frontend, then decode_steps",
           "rows": rows, "prompt": s, "new_tokens": new,
           "streams_equal": out["cuda"][1] == out["cpu"][1],
           "stream": out["cuda"][1],
           "prefill_logits_max_abs_diff": float(
               (out["cuda"][0] - out["cpu"][0]).abs().max()),
           "cross_kv_abs_sum": out["cuda"][2],
           "seconds": time.perf_counter() - t0}
    res["equal"] = res["streams_equal"] and out["cuda"][2] > 0
    emit(res)
    if not res["equal"]:
        raise AssertionError(f"{label}: Model.prefill then decode differs "
                             f"between card and CPU, or the cross K/V "
                             f"stayed zero")
    return res


def cross_parity(dev) -> list:
    """seamless-m4t-medium and llama-3.2-vision-90b at ``CROSS_PARITY``'s
    cut, card against CPU on the same CPU-drawn weights: 4 requests of
    20-48 tokens, 8 new tokens each, through the paged and the slot
    engine (seamless also paged int8, its projections and the
    cross-attentions' packed, and the paged pipeline in 2 stages), as
    ``_parity_config`` holds them (the cross K/V zeroed at admission);
    then each through ``prefill_parity``, whose cross K/V are real."""
    from repro_torch.configs import get_config
    out = []
    for arch, runs in ((SEAMLESS, (("paged", None, None),
                                   ("slot", None, None),
                                   ("paged", "int8", None),
                                   ("pipe_paged", None, None))),
                       (VISION_ARCH, (("paged", None, None),
                                      ("slot", None, None)))):
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  **CROSS_PARITY[arch])
        params = _card_drawn(cfg, dev)
        label = (f"{arch}, {cfg.n_layers} layers {cfg.block_pattern}"
                 + (f", {cfg.n_encoder_layers} encoder layers"
                    if cfg.is_encoder_decoder else f", d_ff {cfg.d_ff}")
                 + ", float32")
        res = _parity_config(
            dev, cfg, label, runs,
            _trace(np.random.default_rng(SEED + 22), 4, 20, 48,
                   cfg.vocab_size), 128, n_new=8, params_cpu=params)
        out += [res, prefill_parity(dev, cfg, params, label)]
        del params
    return out


#: zamba2-7b's parity cell: full width (d_model 3584, d_inner 7168,
#: d_state 64, MHA 32 heads of 112), float32, cut to two Mamba2 layers and
#: two positions of the weight-shared attn block, so that the 2-stage
#: pipeline's boundary (layer 2) falls between the shared positions
ZAMBA_PARITY = ("mamba2", "attn", "mamba2", "attn")


def zamba_parity(dev) -> dict:
    """zamba2-7b at ``ZAMBA_PARITY``'s cut, card against CPU on the same
    weights (``_card_drawn``): 4 requests of at most 64 tokens, 8 new
    tokens each, through the paged engine (unquantized and int8: the
    shared block's seven projections packed, the Mamba2 blocks dense),
    the slot engine and the paged pipeline (2 stages, round-robin, each
    stage on the one shared set), as ``_parity_config`` holds them."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("zamba2-7b"), dtype="float32",
                              n_layers=len(ZAMBA_PARITY),
                              block_pattern=ZAMBA_PARITY)
    params = _card_drawn(cfg, dev)
    return _parity_config(
        dev, cfg, "zamba2-7b, 4 layers (mamba2, shared attn, mamba2, "
                  "shared attn), float32",
        (("paged", None, None), ("slot", None, None),
         ("paged", "int8", None), ("pipe_paged", None, None)),
        _trace(np.random.default_rng(SEED + 15), 4, 20, 64, cfg.vocab_size),
        128, n_new=8, params_cpu=params, cpu_all=False)


#: mixtral-8x7b's parity cell: full width (d_model 4096, 32/8 heads of
#: 128, 8 experts, top-2), 2 layers, float32, with each expert's d_ff cut
#: from 14336 to 1024 and the window from 4096 to 256 so the CPU's side
#: stays short; prompts of 300-400 tokens wrap the ring
MIXTRAL_PARITY = {"n_layers": 2, "moe_d_ff": 1024, "window": 256}


def mixtral_parity(dev) -> list:
    """mixtral-8x7b at ``MIXTRAL_PARITY``'s cut, card against CPU on the
    same CPU-drawn weights: 3 requests of 300-400 tokens, 8 new tokens
    each, through the paged engine (unquantized and int8: the attention
    projections packed, router and experts dense), the slot engine and
    the paged pipeline (2 stages, round-robin), as ``_parity_config``
    holds them; then the capacity-pressure trace (``moe_pressure``)."""
    import torch
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(
        get_config("mixtral-8x7b"), dtype="float32",
        block_pattern=uniform("swa", MIXTRAL_PARITY["n_layers"]),
        **MIXTRAL_PARITY)
    params = Model(cfg, device=torch.device("cpu")).init(
        torch.Generator().manual_seed(SEED))
    res = _parity_config(
        dev, cfg, "mixtral-8x7b, 2 layers, moe_d_ff 1024, window 256, "
                  "float32",
        (("paged", None, None), ("slot", None, None),
         ("paged", "int8", None), ("pipe_paged", None, None)),
        _trace(np.random.default_rng(SEED + 11), 3, 300, 400,
               cfg.vocab_size), 512, n_new=8, params_cpu=params,
        cpu_all=False)
    return [res, moe_pressure(dev, cfg, params)]


@contextlib.contextmanager
def record_moe():
    """Within the block, each ``moe_apply`` call of the model appends
    (x's shape but its last dim: (B, 1) a decode step, (1, C) a prefill
    chunk; its ``moe_drop_frac`` tensor) to the yielded list; nothing is
    read on the host until the caller reads it."""
    from repro_torch.models import moe
    apply, calls = moe.moe_apply, []

    def recorded(params, x, cfg):
        y, aux = apply(params, x, cfg)
        calls.append((tuple(x.shape[:-1]), aux["moe_drop_frac"]))
        return y, aux
    moe.moe_apply = recorded
    try:
        yield calls
    finally:
        moe.moe_apply = apply


def _drops(calls, shape) -> list:
    """The drop fractions of the recorded calls on x of ``shape`` (its
    last dim left out)."""
    return [float(d) for s, d in calls if s == shape]


def moe_pressure(dev, cfg, params_cpu) -> dict:
    """tests/test_paged.py's capacity-coupled trace on ``cfg``: 12 rows of
    3-token prompts with staggered budgets (3-7 new tokens) through the
    slot engine (32 slots a row, chunks of 4), at K 8 and at K 1, on the
    card and on the CPU.  A decode step of 12 rows gives each expert
    ``_capacity(12)`` = 8 places for 24 claims, and a row whose budget
    ran out keeps feeding token 0 at a frozen pos, its claims ranked with
    the live rows'.  Streams and stamps must be equal card = CPU at each
    K and K 8 = K 1 on each side, and some claim of a decode step must
    have been dropped on the card; the drop fractions are printed."""
    import torch
    from repro_torch.serving.engine import Request, ServingEngine
    cpu = torch.device("cpu")
    params = {"cuda": _to(params_cpu, dev), "cpu": params_cpu}
    t0 = time.perf_counter()
    out, drops = {}, {}
    for name, d in (("cuda", dev), ("cpu", cpu)):
        for k in (8, 1):
            eng = ServingEngine(cfg, params[name], max_batch=12,
                                cache_len=32, prefill_chunk=4,
                                decode_steps=k, device=d)
            reqs = [Request(i, [3 + i, 1, 4], max_new_tokens=3 + (i % 5))
                    for i in range(12)]
            for r in reqs:
                eng.submit(r)
            with record_moe() as calls:
                eng.run()
            out[name, k] = {"streams": {r.id: r.out_tokens for r in reqs},
                            "stamps": {r.id: (r.t_submit, r.t_admit,
                                              r.t_first, r.t_done)
                                       for r in reqs}}
            drops[f"{name}_k{k}"] = _drops(calls, (12, 1))
    card = drops["cuda_k8"]
    res = {"phase": "parity", "config": "mixtral-8x7b, 2 layers, the "
           "capacity-pressure trace (12 rows, K 8 and K 1)",
           "card_equals_cpu": {k: out["cuda", k] == out["cpu", k]
                               for k in (8, 1)},
           "k8_equals_k1": {n: out[n, 8] == out[n, 1]
                            for n in ("cuda", "cpu")},
           "decode_drop_frac_max": max(card),
           "decode_drop_frac_mean": sum(card) / len(card),
           "decode_moe_calls": len(card),
           "drops_equal": drops["cuda_k8"] == drops["cpu_k8"],
           "seconds": time.perf_counter() - t0}
    res["equal"] = (all(res["card_equals_cpu"].values())
                    and all(res["k8_equals_k1"].values()))
    emit(res)
    if not res["equal"] or not max(card) > 0:
        raise AssertionError(f"capacity-pressure trace: card against CPU "
                             f"{res['card_equals_cpu']}, K 8 against K 1 "
                             f"{res['k8_equals_k1']}, decode drop fraction "
                             f"up to {max(card)} (must be above 0)")
    return res


#: tests/test_paged.py's GOODPUT_TRACE: two batch hogs ahead of four
#: interactive requests (qos, prompt, max_new_tokens)
GOODPUT_TRACE = [
    ("batch", [5, 6, 7], 20),
    ("batch", [9, 10, 4], 20),
    ("interactive", [11, 3, 5], 4),
    ("interactive", [2, 8], 4),
    ("interactive", [7, 7, 1], 4),
    ("interactive", [4, 9, 9, 2], 4),
]


def policy_parity(dev, cfg) -> dict:
    """The overload trace through the paged engine (2 rows of 32 tokens,
    K = 8) under FIFO, ``edf`` and ``edf_ec`` on the card and on the CPU
    (``cfg``: smollm-360m, 2 layers, float32): streams, stamps, goodput,
    per-class stats and rejections must be equal across devices, and
    each deadline policy's streams FIFO's (a policy reorders which rows
    run, never what they compute)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import PagedServingEngine, Request
    from repro_torch.serving.scheduler import goodput, per_class_stats
    cpu = torch.device("cpu")
    params_cpu = Model(cfg, device=cpu).init(
        torch.Generator().manual_seed(SEED))
    params = {"cuda": _to(params_cpu, dev), "cpu": params_cpu}
    t0 = time.perf_counter()
    out = {}
    for policy in ("fifo", "edf", "edf_ec"):
        for name, d in (("cuda", dev), ("cpu", cpu)):
            eng = PagedServingEngine(cfg, params[name], max_rows=2,
                                     max_len=32, block_size=8,
                                     prefill_chunk=4, decode_steps=8,
                                     policy=policy, device=d)
            reqs = [Request(i, list(p), max_new_tokens=n, qos=q)
                    for i, (q, p, n) in enumerate(GOODPUT_TRACE)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            out[policy, name] = {
                "streams": {r.id: r.out_tokens for r in reqs},
                "stamps": {r.id: (r.t_submit, r.t_admit, r.t_first,
                                  r.t_done) for r in reqs},
                "goodput": goodput(reqs), "per_class": per_class_stats(reqs),
                "rejected": [(r.id, r.error) for r in eng.rejected],
                "n_preemptions": eng.n_preemptions}
    runs = [{"policy": policy, "goodput": out[policy, "cuda"]["goodput"],
             "per_class": out[policy, "cuda"]["per_class"],
             "rejected": out[policy, "cuda"]["rejected"],
             "equal": out[policy, "cuda"] == out[policy, "cpu"],
             "streams_equal_fifo": out[policy, "cuda"]["streams"]
             == out["fifo", "cuda"]["streams"]}
            for policy in ("fifo", "edf", "edf_ec")]
    res = {"phase": "parity", "config": "smollm-360m, 2 layers, float32, "
           "the overload trace under each policy", "runs": runs,
           "equal": all(r["equal"] and r["streams_equal_fifo"]
                        for r in runs),
           "seconds": time.perf_counter() - t0}
    emit(res)
    if not res["equal"]:
        raise AssertionError("policies: the card's runs differ from the "
                             "CPU's, or a deadline policy's streams from "
                             "FIFO's")
    return res


def _timed(base):
    """``base`` engine class that splits wall time between prefill
    chunks and macro-steps or verify rounds (``decode_s`` holds the
    device forward and its host sync; ``round_s`` a whole verify round,
    the drafting included)."""
    import torch

    class Timed(base):
        prefill_s = decode_s = round_s = 0.0
        macro_steps = decode_iters = prefill_calls = verify_rounds = 0

        def __init__(self, *args, **kw):
            #: rows of x a forward (a chunk's tokens, a decode
            #: iteration's rows, a verify round's rows x its chunk) ->
            #: forwards: what the quant rules read
            self.forward_rows = collections.Counter()
            super().__init__(*args, **kw)

        def _prefill_row(self, row, toks, pos0):
            t0 = time.perf_counter()
            super()._prefill_row(row, toks, pos0)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            self.prefill_calls += 1
            self.forward_rows[len(toks)] += 1

        def _forward_steps(self, tokens, pos, budgets, k):
            t0 = time.perf_counter()
            out = super()._forward_steps(tokens, pos, budgets, k)
            self.decode_s += time.perf_counter() - t0
            self.macro_steps += 1
            self.decode_iters += k
            self.forward_rows[len(tokens)] += k
            return out

        def _forward_verify(self, tokens, pos, budgets):
            t0 = time.perf_counter()
            out = super()._forward_verify(tokens, pos, budgets)
            self.decode_s += time.perf_counter() - t0
            self.verify_rounds += 1
            self.forward_rows[int(np.size(tokens))] += 1
            return out

        def _spec_tail(self, *args):
            t0 = time.perf_counter()
            out = super()._spec_tail(*args)
            self.round_s += time.perf_counter() - t0
            return out

    return Timed


def projection_bytes(params) -> int:
    """Bytes of the projection weights (``QUANT_KEYS``), packed or not."""
    from repro_torch.models.quantize import QUANT_KEYS, is_quantized
    if isinstance(params, list):
        return sum(projection_bytes(v) for v in params)
    if not isinstance(params, dict):
        return 0
    total = 0
    for key, val in params.items():
        if key in QUANT_KEYS:
            leaves = val.values() if is_quantized(val) else [val]
            total += sum(a.numel() * a.element_size() for a in leaves)
        else:
            total += projection_bytes(val)
    return total


def expected_launches(cfg, slot: bool, qformat, iters: int,
                      chunks: int, names, rounds: int = 0,
                      prefills: int = 0, rows=None) -> tuple:
    """Kernel launches a run of ``iters`` decode iterations, ``chunks``
    prefill chunks, ``rounds`` verify rounds and ``prefills`` calls of
    ``Model.prefill`` implies: per attn or swa layer two rmsnorms (one
    without an MLP), one decode attention, one prefill attention a chunk
    (the ring form for a windowed swa layer, the paged prefill for the
    others) or one batched chunk attention a verify round and, packed, 7
    quant matmuls (4 attention, 3 MLP; a mixture of experts packs only
    the 4 attention projections: its router and experts stay dense); per
    Mamba1 or Mamba2 layer one rmsnorm and one scan (zamba2-7b's 13
    weight-shared attn positions count as 13 attn layers: each launches
    its own kernels); one final rmsnorm per decode iteration and per
    verify round.  A cross read (a ``cross`` layer's, and an
    encoder-decoder's ``enc_xattn`` in each decoder block) is one decode
    attention at pos src - 1 a decode iteration and one launch of the
    flash kernel's cross form a chunk, a verify round or a prefill; its
    K/V come from the caches, so packed it runs 2 quant matmuls (q, o)
    in serving.  A ``cross`` layer has two rmsnorms like an attn layer;
    an encoder-decoder's decoder block one more (``ln_x``, with the
    self-attention's output as its delta).  A ``Model.prefill`` runs the
    contiguous flash form once an attn layer (and once an encoder
    layer, non-causal), the cross form once a cross read, every norm of
    the stack and the final one, and the encoder's two norms a layer and
    its final norm.  Every rmsnorm but the first of a stack takes its
    residual add as a delta (``add_norm``); the final norm takes the last
    block's.  The mixture of experts launches no kernel of the port
    (routing, dispatch, the expert products and the combine are torch
    ops, as the reference computes them outside any Pallas kernel); its
    norm is the MLP's.  ``rows`` (rows of x a forward -> forwards, the
    run's decode iterations, chunks and verify rounds) gives a packed
    run's quant launches by body too (``quant_bodies``).  Returns
    (launches by kernel, launches by body of rmsnorm and, with ``rows``,
    of the quant kernel)."""
    n_swa = cfg.block_pattern.count("swa")
    n_ring = n_swa if cfg.window else 0
    n_attn = cfg.block_pattern.count("attn") + n_swa
    n_cross = cfg.block_pattern.count("cross")
    n_xread = n_cross + (n_attn if cfg.is_encoder_decoder else 0)
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    n_mamba = (cfg.block_pattern.count("mamba1")
               + cfg.block_pattern.count("mamba2"))
    n_mlp = n_attn + n_cross if cfg.mlp_kind != "none" else 0
    n_packed_mlp = n_mlp if cfg.mlp_kind == "dense" else 0
    expect = dict.fromkeys(names, 0)
    norms = (n_attn + n_cross + n_mamba + n_mlp
             + (n_attn if cfg.is_encoder_decoder else 0))
    heads = iters + rounds + prefills   # forwards ending in the final norm
    enc_norms = 2 * n_enc * prefills    # all add_norm but the first
    expect["rmsnorm"] = ((norms + 1) * heads + norms * chunks
                         + enc_norms + (prefills if n_enc else 0))
    norm_bodies = {"add_norm": norms * heads + (norms - 1) * chunks
                   + enc_norms,
                   "norm": heads + chunks + (prefills if n_enc else 0),
                   "cuda_core": 0}
    expect["paged_prefill_attention"] = (n_attn - n_ring) * chunks
    expect["ring_chunk_attention"] = n_ring * chunks
    expect["paged_chunk_attention"] = n_attn * rounds
    expect["paged_cross_attention"] = n_xread * (chunks + rounds + prefills)
    expect["flash_attention"] = (n_attn + n_enc) * prefills
    expect["dense_decode_attention" if slot
           else "paged_decode_attention"] = (n_attn + n_xread) * iters
    expect["selective_scan"] = n_mamba * (iters + chunks + prefills)
    by_body = {"rmsnorm": norm_bodies}
    if qformat:
        expect[f"quant_matmul_{qformat}"] = (
            (4 * n_attn + 2 * n_xread + 3 * n_packed_mlp) * (heads + chunks)
            + (2 * n_xread + 7 * n_enc) * prefills)
        if rows is not None:
            if sum(rows.values()) != heads + chunks or prefills:
                raise AssertionError(f"{cfg.name}: forwards by rows {rows} "
                                     f"against {heads} heads, {chunks} "
                                     f"chunks and {prefills} prefills")
            d, q_w, kv_w = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                            cfg.n_kv_heads * cfg.head_dim)
            # a forward's launches at each (K, N): wq and wo an attn
            # layer and a cross read, wk and wv an attn layer, the MLP's
            sites = [((d, q_w), n_attn + n_xread), ((d, kv_w), 2 * n_attn),
                     ((q_w, d), n_attn + n_xread),
                     ((d, cfg.d_ff), 2 * n_packed_mlp),
                     ((cfg.d_ff, d), n_packed_mlp)]
            by_body[f"quant_matmul_{qformat}"] = quant_bodies(
                cfg, qformat, sites, rows)
    return expect, by_body


def quant_bodies(cfg, qformat, sites, rows) -> dict:
    """Launches of ``cfg``'s quant kernel by body over forwards of
    ``rows`` (rows of x -> forwards), each of ``sites`` ((K, N),
    launches a forward) on the body its rule names at those rows (int4
    at the packer's group)."""
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.quant_matmul import int4_body, int8_body
    from repro_torch.models.quantize import int4_group
    dtype = torch_dtype(cfg.dtype)
    out = {"cuda_core": 0, "mma": 0, "wgmma": 0}
    for (k, n), per in sites:
        for m, forwards in (rows.items() if per else ()):
            body = (int8_body(dtype, k, n) if qformat == "int8"
                    else int4_body(dtype, m, k, n, int4_group(k)))
            out[body] += per * forwards
    return out


def quant_sites(cfg) -> list:
    """The (K, N) of ``cfg``'s packed projections (``QUANT_KEYS``): wq,
    wk / wv, wo and, with a dense MLP, w_gate / w_up and w_down (a cross
    read's q and o are wq's and wo's)."""
    d, q_w, kv_w = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                    cfg.n_kv_heads * cfg.head_dim)
    sites = [(d, q_w), (d, kv_w), (q_w, d)]
    if cfg.mlp_kind == "dense":
        sites += [(d, cfg.d_ff), (cfg.d_ff, d)]
    return sites


def main_bodies(cfg) -> dict:
    """``MAIN_BODY`` with each of ``cfg``'s attention kernels on the body
    ``ATTN_BODY`` fixes for it (the cross form only for a config with
    cross reads) and its quant matmuls on the bodies the rules name at
    its projection sites (``quant_sites``; int4 at the packer's group,
    at ``QUANT_ROWS``); raises if a wrapper's rule would send the
    config's launches elsewhere, the quant matmuls' than ``QUANT_BODY``
    fixes for the configs served packed in bf16."""
    from repro_torch.device import torch_dtype
    from repro_torch.kernels.decode_attention import decode_body
    from repro_torch.kernels.flash_attention import (chunk_body, cross_body,
                                                     ring_body)
    from repro_torch.kernels.quant_matmul import int4_body, int8_body
    from repro_torch.models.quantize import int4_group
    if not cfg.n_kv_heads:
        return MAIN_BODY
    dtype = torch_dtype(cfg.dtype)
    named_q = {"quant_matmul_int8": {int8_body(dtype, k, n)
                                     for k, n in quant_sites(cfg)},
               "quant_matmul_int4": {int4_body(dtype, m, k, n,
                                               int4_group(k))
                                     for k, n in quant_sites(cfg)
                                     for m in QUANT_ROWS}}
    fixed_q = QUANT_BODY.get(cfg.name)
    if fixed_q and dtype == torch_dtype("bfloat16") and any(
            named != set(fixed_q[k]) for k, named in named_q.items()):
        raise AssertionError(f"{cfg.name}: the quant rules name {named_q} "
                             f"at the sites {quant_sites(cfg)}, expected "
                             f"{fixed_q}")
    rules = {"chunk_body": chunk_body(dtype, cfg.head_dim),
             "ring_body": ring_body(dtype, cfg.head_dim),
             "cross_body": cross_body(dtype, cfg.head_dim),
             "decode_body": decode_body(dtype, cfg.head_dim,
                                        cfg.n_heads // cfg.n_kv_heads)}
    fixed = ATTN_BODY.get(cfg.name, {})
    kernels = [k for k in ATTN_RULE if k != "paged_cross_attention"
               or "cross" in cfg.block_pattern or cfg.is_encoder_decoder]
    bodies = {k: fixed.get(k, "mma") for k in kernels}
    named = {k: rules[ATTN_RULE[k]] for k in kernels}
    if named != bodies:
        raise AssertionError(f"{cfg.name}: the wrappers' rules name the "
                             f"bodies {named}, expected {bodies}")
    return {**MAIN_BODY, **{k: tuple(sorted(v)) for k, v in named_q.items()},
            **{k: (b,) for k, b in bodies.items()}}


def serve_run(name, cls, cfg, kw, prompts, dev, ref=None, n_new=64,
              params=None, ref_key="share_equal_to_bf16_paged",
              setup=None) -> tuple:
    """One serve run at full width and depth: a warm-up engine (cuBLAS
    handles, allocator pools; its launches are not counted), then the
    measured engine on the same parameters (``params``, or the warm-up
    engine's own draw).  ``setup(engine)``, if given, runs on the
    measured engine before any request is submitted (a pipelined run's
    profile -> place step) and returns fields for the run's line.  Launch
    counts are reset just before the run and read just after, and must
    equal what the run's decode iterations and prefill chunks (and
    verify rounds) imply, a model draft's decode iterations and prefill
    chunks included (counted by ``serving/instrument.py``, whose
    dispatch counts the line prints and which must match the engine's
    own: a decode dispatch a macro-step, a verify dispatch a round, a
    prefill dispatch a chunk, each stage's for a pipeline).  ``ref``: a
    reference run's streams on the same requests, for the share of
    equal tokens, printed under ``ref_key``."""
    import gc
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import Request
    from repro_torch.serving.instrument import instrument
    t_call = time.perf_counter()
    timed_cls = _timed(cls)
    warm = timed_cls(cfg, params, **kw)
    warm.submit(Request(-1, list(range(1, 40)), max_new_tokens=4))
    warm.run()
    eng = timed_cls(cfg, warm.params, **kw)
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    extra = setup(eng) if setup is not None else {}
    counts = instrument(eng)
    for i, pr in enumerate(prompts):
        eng.submit(Request(i, pr, max_new_tokens=n_new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    bodies = {k: dict(v) for k, v in _build.bodies.items()}
    iters, chunks = eng.decode_iters, eng.prefill_calls
    rounds = eng.verify_rounds
    expect, expect_bodies = expected_launches(
        cfg, not hasattr(eng, "pc"), eng.quantization, iters, chunks,
        launches, rounds, rows=eng.forward_rows)
    dispatches = dict(counts.counts)
    draft_iters = sum(int(key[len("draft.draft_step"):]) * n
                      for key, n in dispatches.items()
                      if key.startswith("draft.draft_step"))
    draft_chunks = sum(n for key, n in dispatches.items()
                       if key.startswith("draft.draft_fill"))
    if draft_iters or draft_chunks:
        # the model draft's own forwards: dense caches, as a slot engine's
        more, more_bodies = expected_launches(
            eng.spec.provider.cfg, True, None, draft_iters, draft_chunks,
            launches)
        expect = {k: expect[k] + more[k] for k in expect}
        expect_bodies = {**expect_bodies, "rmsnorm": {
            b: n + more_bodies["rmsnorm"][b]
            for b, n in expect_bodies["rmsnorm"].items()}}
    n_stages = len(getattr(eng, "stages", [])) or 1
    dispatch_ok = (counts.decode_dispatches == eng.macro_steps
                   and counts.verify_dispatches == rounds
                   and counts.prefill_dispatches == chunks * n_stages)
    streams = {r.id: r.out_tokens for r in done}
    res = {"phase": "serve", "run": name,
           "engine": cls.__name__, "quantization": eng.quantization,
           "config": f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}",
           "requests": len(prompts), "finished": len(done),
           "prompt_tokens": sum(len(p) for p in prompts),
           "prefill_tokens": eng.prefill_tokens,
           "generated_tokens": eng.tokens_generated,
           "wall_s": wall, "prefill_s": eng.prefill_s,
           "decode_s": eng.decode_s,
           "prefill_tok_per_s": eng.prefill_tokens / eng.prefill_s,
           "decode_tok_per_s": eng.tokens_generated / eng.decode_s,
           "macro_steps": eng.macro_steps, "decode_iters": iters,
           "ms_per_macro_step": (eng.decode_s / eng.macro_steps * 1e3
                                 if eng.macro_steps else None),
           "prefill_calls": chunks,
           "n_host_syncs": eng.n_host_syncs,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "projection_weight_bytes": projection_bytes(eng.params),
           "n_preemptions": getattr(eng, "n_preemptions", None),
           "launches": launches, "launches_expected": expect,
           "bodies": bodies, "bodies_expected": expect_bodies,
           "dispatches": dispatches, **extra}
    if hasattr(eng, "stages"):
        res.update(
            stages=[(st.lo, st.hi) for st in eng.stages],
            placement=eng.placement, transfer_ms=eng.transfer_ms,
            transfer_mb=eng.transfer_mb,
            transfer_ms_per_token=eng.transfer_ms / eng.tokens_generated,
            transfer_mb_per_token=eng.transfer_mb / eng.tokens_generated,
            hops={f"{a}->{b}": h for (a, b), h in eng.hops.items()})
    if eng.spec is not None:
        res.update(
            speculative_k=eng.spec.k, verify_rounds=rounds,
            acceptance_rate=eng.acceptance_rate,
            spec_accept_mean=eng.spec_accept_mean(),
            host_syncs_per_token=eng.n_host_syncs / eng.tokens_generated,
            ms_per_verify_round=eng.decode_s / rounds * 1e3,
            round_s=eng.round_s,
            round_tok_per_s=eng.tokens_generated / eng.round_s)
    if ref is not None:
        pairs = [(a, b) for rid, toks in streams.items()
                 for a, b in zip(toks, ref[rid])]
        res[ref_key] = sum(a == b for a, b in pairs) / len(pairs)
    res["seconds"] = time.perf_counter() - t_call   # warm-up included
    emit(res)
    bad = [r.id for r in done
           if len(r.out_tokens) != n_new
           or not all(0 <= t < cfg.vocab_size for t in r.out_tokens)]
    if len(done) != len(prompts) or bad or eng.rejected:
        raise AssertionError(f"serve {name}: {len(done)}/{len(prompts)} "
                             f"finished, bad streams {bad}, rejected "
                             f"{[r.id for r in eng.rejected]}")
    if not dispatch_ok:
        raise AssertionError(f"serve {name}: dispatches {dispatches} against "
                             f"{eng.macro_steps} macro-steps, {rounds} "
                             f"verify rounds and {chunks} prefill chunks")
    check_launches(name, cfg, launches, expect, bodies, expect_bodies)
    return res, streams, eng


def check_launches(name, cfg, launches, expect, bodies, expect_bodies,
                   more_main=None):
    """A bf16 serve run's launches against ``expected_launches``: every
    kernel's count, and each launch of a kernel with more than one body
    on its main body (the attention kernels' as ATTN_BODY fixes it, the
    scan's state_lanes, rmsnorm's add_norm or norm, and ``more_main``'s
    where given), rmsnorm's split between those two and a packed run's
    quant launches' between its bodies as the run implies."""
    if launches != expect or any(launches[k] == 0
                                 for k, v in expect.items() if v):
        raise AssertionError(f"serve {name}: kernel launches {launches}, "
                             f"expected {expect}")
    bodies_main = {**main_bodies(cfg), **(more_main or {})}

    def on_main(k, b):
        main = bodies_main.get(k, ("mma",))
        return (sum(b[x] for x in main) == launches[k]
                and all(n == 0 for x, n in b.items() if x not in main))
    if not all(on_main(k, b) for k, b in bodies.items()) or any(
            bodies[k] != v for k, v in expect_bodies.items()):
        raise AssertionError(f"serve {name}: launches by body {bodies}, "
                             f"expected every launch on a body of "
                             f"{bodies_main} (else mma), and "
                             f"{expect_bodies}")


def serve(dev) -> dict:
    """smollm-360m: the bf16 paged run of 16 requests and its decode
    profile, then the slot engine and the int8 / int4 paged engine on its
    first 8 requests, speculation, the pipelined engines and the
    policies; then falcon-mamba-7b (``serve_mamba``), gemma3-12b
    (``serve_gemma``) and mixtral-8x7b (``serve_mixtral``).  Returns each
    run's launch counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = get_config("smollm-360m")
    kw = dict(max_rows=8, max_len=1024, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 2), 16, 32, 512,
                     cfg.vocab_size)
    res, ref, eng = serve_run("paged_bf16", PagedServingEngine, cfg, kw,
                              prompts, dev)
    launches = {"paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="paged_bf16")
    profile_prefill(cfg, eng.params, kw, dev, label="paged_bf16")
    del eng
    slot_kw = dict(max_batch=8, cache_len=1024, prefill_chunk=128,
                   decode_steps=16, seed=SEED, device=dev)
    mono = {}
    # the last run repeats the bf16 paged engine on the same 8 requests,
    # so each quantized or slot run has an equal-sized bf16 neighbour in
    # this process
    for name, cls, run_kw in (
            ("dense_bf16", ServingEngine, slot_kw),
            ("paged_int8", PagedServingEngine, dict(kw, quantization="int8")),
            ("paged_int4", PagedServingEngine, dict(kw, quantization="int4")),
            ("paged_bf16_8", PagedServingEngine, kw)):
        gc.collect()
        torch.cuda.empty_cache()
        res, streams, eng = serve_run(name, cls, cfg, run_kw, prompts[:8],
                                      dev, ref=ref)
        launches[name] = res["launches"]
        if name in ("dense_bf16", "paged_bf16_8"):
            mono[name] = (res, streams)
        if name == "paged_bf16_8":
            streams_8 = streams
        if name in ("paged_int8", "paged_int4"):
            profile_decode(cfg, eng.params, run_kw, dev, label=name)
        del eng
    # draft-verify speculation (K = 4, n-gram drafts) on the same 8
    # requests, with the share of tokens equal to paged_bf16_8's (not
    # gated: in bf16 the chunk kernel and the decode kernel round
    # differently, and random 32-layer weights amplify that)
    for name, cls, run_kw in (
            ("paged_spec", PagedServingEngine, dict(kw, speculative=4)),
            ("dense_spec", ServingEngine, dict(slot_kw, speculative=4))):
        gc.collect()
        torch.cuda.empty_cache()
        res, _, eng = serve_run(name, cls, cfg, run_kw, prompts[:8], dev,
                                ref=streams_8,
                                ref_key="share_equal_to_paged_bf16_8")
        launches[name] = res["launches"]
        # one batched chunk attention a layer a round (32 on smollm)
        if res["launches"]["paged_chunk_attention"] != cfg.n_layers * res[
                "verify_rounds"] or res["verify_rounds"] == 0:
            raise AssertionError(f"serve {name}: {res['verify_rounds']} "
                                 f"verify rounds, batched chunk attention "
                                 f"launched {res['launches']}")
        if name == "paged_spec":
            profile_verify(cfg, eng.params, run_kw, dev, label=name)
        del eng
    del res, streams, streams_8
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.serving.pipeline import (PagedPipelinedEngine,
                                              PipelinedEngine)
    launches.update(serve_pipelined(
        cfg, [(*PIPE_RUNS[0], PagedPipelinedEngine, kw),
              (*PIPE_RUNS[1], PipelinedEngine, slot_kw)], prompts[:8], dev,
        mono))
    del mono
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_policy(cfg, kw, prompts, dev, ref))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_mamba(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_gemma(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_mixtral(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_zamba(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_seamless(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_vision(dev))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_targets(dev))
    return launches


#: the pipelined serve runs, each beside the monolithic run it must equal
PIPE_RUNS = (("pipe_paged_bf16", "paged_bf16_8"),
             ("pipe_dense_bf16", "dense_bf16"))
#: peak memory of a pipelined run over its monolithic run's, at most
PIPE_PEAK_RATIO = 1.05
#: the edf_ec run's pool: 96 blocks of 16 (1536 tokens) against 16
#: requests of 64-544 tokens through 8 rows, so admissions wait
EDF_POOL_BLOCKS = 96
#: new tokens a request of the policy runs (``paged_bf16``'s 64 halved
#: to keep the script inside its time; the share equal to
#: ``paged_bf16``'s compares their first 32)
POLICY_NEW_TOKENS = 32


def _profile_and_place(eng) -> dict:
    """The static tier on the card: each stage's decode step timed by
    CUDA events (``profile``), the executed pipeline turned into the
    paper's application (``to_application``), its core stages placed by
    the integer program (``place_stages(..., "static_ip")``) over the
    engine's seeded edge network, and the placement set."""
    from repro_torch.models.quantize import bytes_per_param
    from repro_torch.serving.pipeline import place_stages
    t0 = time.perf_counter()
    stage_ms = eng.profile()
    app = eng.to_application(np.random.default_rng(SEED),
                             measured_ms=stage_ms)
    placement = place_stages(app, eng.net, "static_ip",
                             bytes_per_param=bytes_per_param(
                                 eng.quantization))
    eng.set_placement(placement)
    return {"stage_ms": stage_ms, "static_ip_placement": placement,
            "entry_node": eng.entry_node,
            "profile_place_s": time.perf_counter() - t0}


def serve_pipelined(cfg, runs, prompts, dev, mono, setup=None) -> dict:
    """A model at full width and depth, bf16, split in 2 core stages over
    a seeded edge network (``make_network``): each of ``runs`` (name, the
    monolithic run it must equal, engine class, engine kwargs; for
    smollm-360m ``pipe_paged_bf16`` with ``PagedPipelinedEngine`` and
    ``pipe_dense_bf16`` with ``PipelinedEngine``) on the requests of its
    monolithic run (``mono``: their lines and streams), each after the
    profile -> place step (``_profile_and_place``) and ``setup(engine)``
    where given.  Each must emit its monolithic run's tokens, launch
    every kernel as often a decode iteration and a prefill chunk as the
    monolithic engine does (the formula ``serve_run`` checks, by kernel
    and body) and peak within 5% of its memory.  Prints each run's stage
    times, placement, simulated transfer a token, tok/s, peak memory and
    launches beside the monolithic run's.  Returns each run's launch
    counts."""
    import gc
    import torch
    from repro_torch.core.network import make_network
    net = make_network(np.random.default_rng(SEED))
    launches = {}

    def place(eng):
        return {**_profile_and_place(eng), **(setup(eng) if setup else {})}
    for name, mono_name, cls, run_kw in runs:
        gc.collect()
        torch.cuda.empty_cache()
        res, streams, eng = serve_run(
            name, cls, cfg, dict(run_kw, n_stages=2, net=net), prompts, dev,
            setup=place)
        del eng
        launches[name] = res["launches"]
        mres, mstreams = mono[mono_name]
        keys = ("decode_tok_per_s", "prefill_tok_per_s", "wall_s",
                "max_memory_allocated", "decode_iters", "prefill_calls",
                "launches", "bodies")
        cmp = {"phase": "serve", "run": name, "beside": mono_name,
               "tokens_equal": streams == mstreams,
               "peak_ratio": (res["max_memory_allocated"]
                              / mres["max_memory_allocated"]),
               name: {k: res[k] for k in keys}, mono_name: {
                   k: mres[k] for k in keys}}
        emit(cmp)
        # equal streams mean equal scheduling: the same decode iterations
        # and prefill chunks, so every kernel's launches, body by body,
        # must be the monolithic run's exactly
        same = (cmp["tokens_equal"]
                and (res["decode_iters"], res["prefill_calls"]) == (
                    mres["decode_iters"], mres["prefill_calls"])
                and res["launches"] == mres["launches"]
                and res["bodies"] == mres["bodies"])
        if not same or cmp["peak_ratio"] > PIPE_PEAK_RATIO:
            raise AssertionError(f"serve {name}: tokens, decode iterations, "
                                 f"prefill chunks or launches by body differ "
                                 f"from {mono_name}'s ({cmp}), or peak memory "
                                 f"ratio {cmp['peak_ratio']} over "
                                 f"{PIPE_PEAK_RATIO}")
    return launches


def serve_policy(cfg, kw, prompts, dev, ref) -> dict:
    """``edf_ec_paged``: the 16 requests of ``paged_bf16`` with QoS
    classes assigned round-robin from ``QOS_CLASSES`` and
    ``POLICY_NEW_TOKENS`` new tokens each, through the paged
    engine in a pool of ``EDF_POOL_BLOCKS`` blocks (requests wait for
    blocks), under FIFO and then under ``edf_ec``, on the same weights.
    Every kernel's launches, by kernel and body, are checked as in
    ``serve_run`` (``check_launches``).  Prints each
    run's goodput, per-class stats, rejections and preemptions, and, for
    the requests finished under both, the share of tokens equal to
    ``paged_bf16``'s (``ref``; not gated: bf16 rows can round
    differently in other co-batches).  Returns each run's launches."""
    import gc
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import PagedServingEngine, Request
    from repro_torch.serving.scheduler import (QOS_CLASSES, goodput,
                                               per_class_stats)
    classes = list(QOS_CLASSES)
    timed_cls = _timed(PagedServingEngine)
    params, out, launches = None, {}, {}
    for name, policy in (("fifo_paged", "fifo"), ("edf_ec_paged", "edf_ec")):
        gc.collect()
        torch.cuda.empty_cache()
        t_call = time.perf_counter()
        eng = timed_cls(cfg, params, num_blocks=EDF_POOL_BLOCKS,
                        policy=policy, **kw)
        params = eng.params
        reqs = [Request(i, pr, max_new_tokens=POLICY_NEW_TOKENS,
                        qos=classes[i % len(classes)])
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        bodies = {k: dict(v) for k, v in _build.bodies.items()}
        expect, expect_bodies = expected_launches(
            cfg, False, None, eng.decode_iters, eng.prefill_calls, counts)
        finished = {r.id: r.out_tokens for r in done}
        out[name] = finished
        res = {"phase": "serve", "run": name, "policy": policy,
               "config": f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}",
               "num_blocks": EDF_POOL_BLOCKS, "requests": len(reqs),
               "finished": len(done), "goodput": goodput(reqs),
               "per_class": per_class_stats(reqs),
               "rejected": [(r.id, r.qos, r.error) for r in eng.rejected],
               "unfinished": [r.id for r in eng.unfinished],
               "n_preemptions": eng.n_preemptions, "wall_s": wall,
               "decode_iters": eng.decode_iters,
               "prefill_calls": eng.prefill_calls,
               "generated_tokens": eng.tokens_generated,
               "launches": counts, "launches_expected": expect,
               "bodies": bodies, "bodies_expected": expect_bodies,
               "seconds": time.perf_counter() - t_call}
        emit(res)
        launches[name] = counts
        if eng.unfinished:
            raise AssertionError(f"serve {name}: unfinished "
                                 f"{res['unfinished']}")
        check_launches(name, cfg, counts, expect, bodies, expect_bodies)
        del eng
    both = sorted(set(out["fifo_paged"]) & set(out["edf_ec_paged"]))

    def share(streams):
        pairs = [(a, b) for rid in both
                 for a, b in zip(streams[rid], ref[rid])]
        return sum(a == b for a, b in pairs) / max(1, len(pairs))
    emit({"phase": "serve", "run": "edf_ec_paged", "beside": "fifo_paged",
          "finished_under_both": len(both),
          "share_equal_to_paged_bf16": {
              k: share(v) for k, v in out.items()}})
    return launches


#: gemma3-12b's serve runs: full width, 12 of its 48 layers (the 5:1
#: pattern kept: 10 swa, 2 attn; 24 before the scale phase took its
#: time), so the whole script stays inside the time a run may take
GEMMA_LAYERS = 12


def serve_gemma(dev) -> dict:
    """gemma3-12b at full width and ``GEMMA_LAYERS`` of its 48 layers (10
    ``swa`` with the 1024-slot ring and 2 ``attn``; about 7.3 GB of bf16
    weights drawn on the card from the seed): 8 requests of 256-2048 tokens (six past the
    window) through ``PagedServingEngine`` and its decode and prefill
    profiles (prompts past the window, so both windows run the wrapped
    ring), then the same 8 through
    ``ServingEngine`` on the same weights, with its share of tokens equal
    to the paged run's.  Every paged-prefill, ring-form and decode launch
    of the serve runs takes the wide ``mma`` body (hd 256).  Returns each
    run's launch counts."""
    import gc
    import torch
    from repro_torch.config import local_global
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              n_layers=GEMMA_LAYERS,
                              block_pattern=local_global(GEMMA_LAYERS, 5))
    max_len = GEMMA["max_len"]
    kw = dict(max_rows=8, max_len=max_len, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 1), 8, 256, 2048,
                     cfg.vocab_size)
    if sum(len(p) > cfg.window for p in prompts) < 4:
        raise AssertionError("the gemma3 trace must hold at least four "
                             "prompts past the window")
    res, ref, eng = serve_run("gemma_paged_bf16", PagedServingEngine, cfg,
                              kw, prompts, dev)
    launches = {"gemma_paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="gemma_paged_bf16",
                   prompt_len=1153)
    profile_prefill(cfg, eng.params, kw, dev, label="gemma_paged_bf16",
                    prompt_len=1153, requests=2)
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "gemma_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=max_len, prefill_chunk=128,
             decode_steps=16, seed=SEED, device=dev), prompts, dev, ref=ref,
        params=params)
    launches["gemma_dense_bf16"] = res["launches"]
    return launches


#: mixtral-8x7b on one card: full width, 8 of its 32 layers.  All 32
#: would hold about 93 GB of bf16 weights (a layer's experts are 3 x 8 x
#: 4096 x 14336 x 2 B = 2.82 GB, its attention 84 MB) against the card's
#: 80 GB, and the reference never packs expert weights, so quantization
#: cannot close the gap; 16 fit (about 46.4 GB of blocks), and 8 (about
#: 23.2 GB, plus 0.52 GB of embedding and untied head) keep the whole
#: script inside the time a run may take; 4 since the scale phase took
#: its time
MIXTRAL_LAYERS = 4


def _moe_bytes(params) -> int:
    """Bytes of the MoE leaves (router and experts)."""
    return sum(v.numel() * v.element_size()
               for seg in params["blocks"]["segments"]
               for v in seg.get("moe", {}).values())


def _drop_stats(calls, rows: int, chunk: int, n_layers: int) -> dict:
    """The drop fractions a serve run's ``moe_apply`` calls recorded: the
    mean over the layers of its first decode step (``rows`` tokens) and
    of its first full prefill chunk (``chunk`` tokens), and the mean and
    largest over every such call."""
    out = {}
    for label, shape in (("decode", (rows, 1)), ("chunk", (1, chunk))):
        d = _drops(calls, shape)
        out[label] = {"first_step_mean": sum(d[:n_layers]) / n_layers,
                      "mean": sum(d) / len(d), "max": max(d),
                      "calls": len(d)}
    return out


def moe_sync_check(cfg, params, dev) -> dict:
    """``moe_apply`` at full width on the served model's first layer, at a
    decode step's shape (8, 1, 4096) and a prefill chunk's (1, 128,
    4096), bf16, under ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that makes the host wait on the card raises.  Each shape
    runs once before, outside the mode (cuBLAS handles, allocator
    pools)."""
    import torch
    from repro_torch.models.moe import moe_apply
    layer = {k: v[0] for k, v in params["blocks"]["segments"][0]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {"phase": "serve", "check": "moe_apply with no host sync",
           "config": f"{cfg.name}, layer 0, bfloat16", "shapes": {}}
    for shape in ((8, 1, cfg.d_model), (1, MIXTRAL["C"], cfg.d_model)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        moe_apply(layer, x, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_apply(layer, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        res["shapes"][str(list(shape))] = {
            "finite": bool(torch.isfinite(y).all()),
            "moe_drop_frac": float(aux["moe_drop_frac"])}
    emit(res)
    if not all(v["finite"] for v in res["shapes"].values()):
        raise AssertionError(f"moe_apply: non-finite output {res}")
    return res


def serve_mixtral(dev) -> dict:
    """mixtral-8x7b at full width and ``MIXTRAL_LAYERS`` of its 32 layers
    (every layer ``swa`` on a ring of 4096 slots with 8 experts, top-2;
    about 24 GB of bf16 weights drawn on the card from the seed): 8
    requests, 6 of 256-2048 tokens and 2 of 4160-4400 (past the window),
    64 new tokens each, through ``PagedServingEngine``
    (``mixtral_paged_bf16``, profiled in decode and prefill) and
    ``ServingEngine`` on the same weights (``mixtral_dense_bf16``, its
    share of tokens equal to the paged run's printed).  Launches by
    kernel and body are checked exactly as in every serve run (a prefill
    chunk launches the ring form 8 times, a decode iteration the decode
    kernel 8 times, the ring form on ``wgmma`` and the decode on
    ``mma``; the experts launch no port kernel).
    Printed, not gated: the share of claims dropped in the paged run's
    first decode step and first full prefill chunk and over the run
    (capacity ranks claims over the co-batch, so the slot run may
    differ, SERVING.md).  Then ``moe_sync_check``.  Returns each run's
    launch counts."""
    import gc
    import torch
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              n_layers=MIXTRAL_LAYERS,
                              block_pattern=uniform("swa", MIXTRAL_LAYERS))
    max_len = MIXTRAL["max_len"]
    kw = dict(max_rows=8, max_len=max_len, block_size=16,
              prefill_chunk=MIXTRAL["C"], decode_steps=16, seed=SEED,
              device=dev)
    rng = np.random.default_rng(SEED + 12)
    prompts = (_trace(rng, 6, 256, 2048, cfg.vocab_size)
               + _trace(rng, 2, 4160, 4400, cfg.vocab_size))
    cut = (f"{cfg.n_layers} of 32 layers: 32 would hold about 93 GB of "
           f"bf16 weights, more than the card's 80 GB")
    with record_moe() as calls:
        res, ref, eng = serve_run(
            "mixtral_paged_bf16", PagedServingEngine, cfg, kw, prompts, dev,
            setup=lambda e: calls.clear() or {
                "depth_cut": cut, "moe_weight_bytes": _moe_bytes(e.params)})
    emit({"phase": "serve", "run": "mixtral_paged_bf16",
          "moe_drop_frac": _drop_stats(calls, kw["max_rows"], MIXTRAL["C"],
                                       cfg.n_layers)})
    del calls
    launches = {"mixtral_paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="mixtral_paged_bf16",
                   prompt_len=1153)
    profile_prefill(cfg, eng.params, kw, dev, label="mixtral_paged_bf16",
                    prompt_len=1153, requests=2)
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "mixtral_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=max_len, prefill_chunk=MIXTRAL["C"],
             decode_steps=16, seed=SEED, device=dev), prompts, dev, ref=ref,
        params=params, setup=lambda e: {"depth_cut": cut})
    launches["mixtral_dense_bf16"] = res["launches"]
    del eng
    moe_sync_check(cfg, params, dev)
    return launches


#: falcon-mamba-7b's serve runs: full width, 32 of its 64 layers (all 64
#: before the scale phase took its time)
MAMBA_LAYERS = 32


def serve_mamba(dev) -> dict:
    """falcon-mamba-7b at full width and ``MAMBA_LAYERS`` of its 64 Mamba1
    layers (about 8.3 GB of bf16 weights drawn from the seed): 8 requests
    through
    ``PagedServingEngine`` and its decode and prefill-chunk profiles,
    then the same 8 through
    ``ServingEngine`` on the same weights, with its share of tokens equal
    to the paged run's.  Returns each run's launch counts."""
    import gc
    import torch
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=MAMBA_LAYERS,
                              block_pattern=uniform("mamba1", MAMBA_LAYERS))
    kw = dict(max_rows=8, max_len=1024, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 2), 8, 32, 512,
                     cfg.vocab_size)
    res, ref, eng = serve_run("mamba_paged_bf16", PagedServingEngine, cfg,
                              kw, prompts, dev)
    launches = {"mamba_paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="mamba_paged_bf16")
    profile_prefill(cfg, eng.params, kw, dev, label="mamba_paged_bf16")
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "mamba_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=1024, prefill_chunk=128, decode_steps=16,
             seed=SEED, device=dev), prompts, dev, ref=ref, params=params)
    launches["mamba_dense_bf16"] = res["launches"]
    return launches


def _shared_views(eng) -> dict:
    """A pipelined engine's stages against the one weight-shared set of
    its parameters: every stage's ``blocks["shared"]`` leaf must be the
    engine's own tensor (no copy), and its bytes are counted once."""
    shared = eng.params["blocks"]["shared"]
    leaves = {k: v for k, v in shared["attn"].items()}
    same = all(st.params["blocks"]["shared"]["attn"][k].data_ptr()
               == v.data_ptr()
               for st in eng.stages for k, v in leaves.items())
    nbytes = sum(a.numel() * a.element_size() for part in shared.values()
                 for a in part.values())
    if not same:
        raise AssertionError(f"{eng.cfg.name}: a pipeline stage holds a "
                             f"copy of the weight-shared block")
    return {"shared_set_views": same, "shared_set_bytes": nbytes,
            "shared_positions_by_stage": [
                sum(seg.shared for seg in st.segs) for st in eng.stages]}


#: zamba2-7b's serve runs: full width, 21 of its 81 layers (18 Mamba2,
#: 3 positions of the shared attn block; 41 before the scale phase took
#: its time), so the whole script stays inside the time a run
#: may take
ZAMBA_LAYERS = 21


def serve_zamba(dev) -> dict:
    """zamba2-7b at full width and ``ZAMBA_LAYERS`` of its 81 layers (18
    Mamba2 and 3 positions of the one weight-shared attn block; about 3.6
    GB of bf16 weights drawn on the card from the seed): 8 requests of
    256-2048
    tokens, 64 new tokens each, through ``PagedServingEngine``
    (``zamba_paged_bf16``, profiled in decode and prefill) and
    ``ServingEngine`` (``zamba_dense_bf16``, its share of tokens equal to
    the paged run's printed), launches by kernel and body checked
    exactly (a decode iteration: 25 norms, 3 decode attentions, 18
    scans; a chunk: 24 norms, 3 paged prefills, 18 scans; every
    paged prefill on ``wgmma`` and decode on ``mma`` at hd 112, every scan on
    ``state_lanes`` at d_state 64); then ``zamba_pipe_paged_bf16``, the
    paged run's requests through ``PagedPipelinedEngine`` in 2 stages
    placed by the static tier, which must emit the paged run's tokens and launches at a
    peak within 5% of its memory, every stage on the engine's one shared
    set (``_shared_views``).  Returns each run's launch counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    from repro_torch.config import every_kth
    from repro_torch.serving.pipeline import PagedPipelinedEngine
    cfg = dataclasses.replace(
        get_config("zamba2-7b"), n_layers=ZAMBA_LAYERS,
        block_pattern=every_kth(ZAMBA_LAYERS, "mamba2", "attn", 6))
    max_len = ZAMBA["max_len"]
    kw = dict(max_rows=8, max_len=max_len, block_size=16,
              prefill_chunk=ZAMBA["C"], decode_steps=16, seed=SEED,
              device=dev)
    prompts = _trace(np.random.default_rng(SEED + 16), 8, 256, 2048,
                     cfg.vocab_size)
    res, ref, eng = serve_run("zamba_paged_bf16", PagedServingEngine, cfg,
                              kw, prompts, dev)
    launches = {"zamba_paged_bf16": res["launches"]}
    mono = {"zamba_paged_bf16": (res, ref)}
    # no ring to wrap: prompts of 256 tokens, and the 12 chunks of
    # 385-token prompts, as for smollm-360m and falcon-mamba-7b
    profile_decode(cfg, eng.params, kw, dev, label="zamba_paged_bf16")
    profile_prefill(cfg, eng.params, kw, dev, label="zamba_paged_bf16")
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "zamba_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=max_len, prefill_chunk=ZAMBA["C"],
             decode_steps=16, seed=SEED, device=dev), prompts, dev, ref=ref,
        params=params)
    launches["zamba_dense_bf16"] = res["launches"]
    del eng, params, res
    launches.update(serve_pipelined(
        cfg, [("zamba_pipe_paged_bf16", "zamba_paged_bf16",
               PagedPipelinedEngine, kw)], prompts, dev, mono,
        setup=_shared_views))
    return launches


def prefill_run(name, cfg, params, dev, rows: int = 8, prompt: int = 128,
                k: int = 16, macro_steps: int = 4) -> dict:
    """``Model.prefill`` at full width and depth in bf16: ``rows`` prompts
    of ``prompt`` tokens with a frontend of seeded patch or frame
    embeddings (drawn on the card), into dense caches of ``prompt + k *
    macro_steps`` slots, then ``macro_steps`` calls of
    ``decode_steps(k=k)`` on them (the cross layers reading real cross
    K/V).  A warm-up pass first (not counted).  Prints the encoder's
    time alone (an encoder-decoder; CUDA events), the prefill's, the
    decode tok/s and peak memory; the launches, reset just before the
    prefill and read after the last macro-step, must be what
    ``expected_launches`` says of one prefill and ``k * macro_steps``
    dense decode iterations, by kernel and body (the contiguous flash
    form on ``PREFILL_FLASH_BODY``, which ``flash_body`` must name), and
    every token in the vocab."""
    import torch
    from repro_torch.device import torch_dtype
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_body
    from repro_torch.models.model import Model
    t_call = time.perf_counter()
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    src = cfg.n_image_tokens or cfg.encoder_seq
    tokens = torch.randint(1, cfg.vocab_size, (rows, prompt), generator=gen,
                           device=dev, dtype=torch.int32)
    frontend = torch.randn((rows, src, cfg.d_model), generator=gen,
                           device=dev).to(model.dtype)
    batch = {"tokens": tokens, "frontend": frontend}
    cache_len = prompt + k * macro_steps

    def run():
        logits, caches, _ = model.prefill(params, batch, cache_len)
        torch.cuda.synchronize()
        t_pre = time.perf_counter()
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)[:, None]
        emits = []
        for i in range(macro_steps):
            emits.append(model.decode_steps(model.one_stage(params, caches), {
                "token": tok,
                "pos": torch.full((rows,), prompt + i * k, dtype=torch.int32,
                                  device=dev),
                "budget": torch.full((rows,), k, dtype=torch.int32,
                                     device=dev)}, k=k))
            tok = emits[-1][:, -1:]
        out = torch.cat(emits, 1).cpu()
        return logits, caches, out, time.perf_counter() - t_pre

    run()                                            # warm-up
    torch.cuda.synchronize()
    enc_ms = None
    if cfg.is_encoder_decoder:
        enc_ms = call_ms(lambda: model._encode(params, frontend), n=5,
                         warmup=1)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    logits, caches, toks, decode_s = run()
    launches = dict(_build.launches)
    bodies = {kk: dict(v) for kk, v in _build.bodies.items()}
    # the prefill alone, timed again on its own
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    model.prefill(params, batch, cache_len)
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end)
    expect, expect_bodies = expected_launches(
        cfg, True, None, k * macro_steps, 0, launches, prefills=1)
    cross = sum(float(c[n].float().abs().sum()) for c in caches for n in c
                if n in ("xk", "xv"))
    res = {"phase": "serve", "run": name, "path": "Model.prefill, then "
           "decode_steps on the dense caches",
           "config": f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}",
           "rows": rows, "prompt": prompt, "frontend": [rows, src,
                                                        cfg.d_model],
           "encoder_ms": enc_ms, "prefill_ms": prefill_ms,
           "prefill_tok_per_s": rows * prompt / prefill_ms * 1e3,
           "decode_iters": k * macro_steps, "decode_s": decode_s,
           "decode_tok_per_s": rows * k * macro_steps / decode_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "logits_finite": bool(torch.isfinite(logits).all()),
           "cross_kv_abs_sum": cross, "launches": launches,
           "launches_expected": expect, "bodies": bodies,
           "bodies_expected": expect_bodies,
           "seconds": time.perf_counter() - t_call}
    emit(res)
    if (not res["logits_finite"] or not cross > 0 or toks.shape != (
            rows, k * macro_steps) or not ((toks >= 0)
                                           & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{name}: non-finite logits, zero cross K/V or "
                             f"tokens out of the vocab")
    rule = flash_body(torch_dtype(cfg.dtype), cfg.head_dim)
    if rule != PREFILL_FLASH_BODY:
        raise AssertionError(f"{name}: flash_body names {rule} at hd "
                             f"{cfg.head_dim}, expected {PREFILL_FLASH_BODY}")
    check_launches(name, cfg, launches, expect, bodies, expect_bodies,
                   {"flash_attention": (PREFILL_FLASH_BODY,)})
    return {name: launches}


def serve_seamless(dev) -> dict:
    """seamless-m4t-medium uncut (12 encoder and 12 decoder layers,
    d_model 1024, 16 / 16 heads of 64, vocab 256206, untied; about 0.98 B
    parameters, 2 GB in bf16) from the seed: 8 requests of 32-512
    tokens, 64 new each, through ``PagedServingEngine``
    (``seamless_paged_bf16``) and ``ServingEngine``
    (``seamless_dense_bf16``, its share of tokens equal to the paged
    run's), the cross K/V zeroed at admission as in the reference, every
    decoder block running its enc_xattn over them (launches by kernel and
    body checked exactly: one more norm a block, one cross read a block);
    then ``seamless_prefill_bf16`` (``prefill_run``: 8 prompts of 128
    with a seeded (8, 1024, 1024) frontend through the encoder, 4
    macro-steps of 16).  Returns each run's launch counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = get_config(SEAMLESS)
    kw = dict(max_rows=8, max_len=1024, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 18), 8, 32, 512,
                     cfg.vocab_size)
    res, ref, eng = serve_run("seamless_paged_bf16", PagedServingEngine,
                              cfg, kw, prompts, dev)
    launches = {"seamless_paged_bf16": res["launches"]}
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "seamless_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=1024, prefill_chunk=128, decode_steps=16,
             seed=SEED, device=dev), prompts, dev, ref=ref, params=params)
    launches["seamless_dense_bf16"] = res["launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(prefill_run("seamless_prefill_bf16", cfg, params, dev))
    return launches


#: llama-3.2-vision-90b on one card: full width, 15 of its 100 layers (the
#: every-fifth pattern kept: 12 attn and 3 cross; 30 before the scale
#: phase took its time).  A layer is 0.856 B parameters
#: (attention 151 M, MLP 705 M), 1.71 GB in bf16: 15 layers are about
#: 25.7 GB, with 4.2 GB of embedding and untied head; all 100 would need
#: about 175 GB against the card's 80 GB
VISION_LAYERS = 15


def serve_vision(dev) -> dict:
    """llama-3.2-vision-90b at full width and ``VISION_LAYERS`` layers in
    bfloat16, about 29.9 GB of weights drawn on the card from the seed: 8
    requests of 256-1024 tokens, 64 new each, through
    ``PagedServingEngine`` (``vision_paged_bf16``, profiled over one
    decode macro-step and 4 prefill chunks) and ``ServingEngine``
    (``vision_dense_bf16``, its share of tokens equal to the paged
    run's), launches by kernel and body checked exactly (per decode
    iteration 12 self-attention and 3 cross decode reads at pos 1600 over
    the zeroed cross K/V; per chunk 12 paged prefills and 3 cross forms);
    then ``vision_prefill_bf16`` (``prefill_run``: 8 prompts of 128 with a
    seeded (8, 1601, 8192) frontend, 4 macro-steps of 16).  Returns each
    run's launch counts."""
    import gc
    import torch
    from repro_torch.config import every_kth
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedServingEngine, ServingEngine
    cfg = dataclasses.replace(
        get_config(VISION_ARCH), n_layers=VISION_LAYERS,
        block_pattern=every_kth(VISION_LAYERS, "attn", "cross", 5))
    max_len = VISION["max_len"]
    kw = dict(max_rows=8, max_len=max_len, block_size=16,
              prefill_chunk=VISION["C"], decode_steps=16, seed=SEED,
              device=dev)
    prompts = _trace(np.random.default_rng(SEED + 20), 8, 256, 1024,
                     cfg.vocab_size)
    res, ref, eng = serve_run("vision_paged_bf16", PagedServingEngine, cfg,
                              kw, prompts, dev)
    launches = {"vision_paged_bf16": res["launches"]}
    profile_decode(cfg, eng.params, kw, dev, label="vision_paged_bf16")
    profile_prefill(cfg, eng.params, kw, dev, label="vision_paged_bf16",
                    prompt_len=VISION["C"] + 1)
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res, _, eng = serve_run(
        "vision_dense_bf16", ServingEngine, cfg,
        dict(max_batch=8, cache_len=max_len, prefill_chunk=VISION["C"],
             decode_steps=16, seed=SEED, device=dev), prompts, dev, ref=ref,
        params=params)
    launches["vision_dense_bf16"] = res["launches"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(prefill_run("vision_prefill_bf16", cfg, params, dev))
    return launches


#: layers of the speculation targets served at full width: 8 of
#: qwen2-72b's 80 (about 14.0 GB of layers and 5.0 GB of embedding and
#: head in bf16; all 80 would need 145 GB) and 8 of command-r-35b's 40
#: (about 11.3 GB and its 4.19 GB tied table)
QWEN_LAYERS = 8
COMMAND_R_LAYERS = 8
#: the model draft of ``qwen_spec_bf16``: smollm-360m's widths (15 / 5
#: heads of 64, d_model 960) at qwen2-72b's vocabulary, so every target
#: token indexes its table, at 4 of its 32 layers (a draft proposes a row
#: at a time, a host loop of launches: at 8 layers it took 12,093
#: launches and 206 ms a verify round, 0.81 of it idle, on an H100 80GB
#: HBM3 at 700 W)
DRAFT_LAYERS = 4
#: new tokens a request of the targets' serve runs
TARGET_NEW = 32


def check_spec_streams(model, params, prompts, got, ref, dev) -> dict:
    """``qwen_spec_bf16``'s streams against ``qwen_paged_bf16``'s.  Greedy
    verification emits the target's own argmax, but in bf16 the verify
    round's forward (a chunk of K + 1 tokens a row: the batched chunk
    kernel, cuBLAS at 40 rows) rounds otherwise than a decode step's, and
    over 152064 bf16 logits the top two often tie or nearly do.  So each
    row's stream must equal the plain run's up to its end, or up to a
    position where the plain path's top-2 logit gap (``_top2_gap``: the
    prefix prefilled, then one decode step) is at most two bf16 rounding
    steps of the top logit, the repo's bf16 gate; there the streams may
    part.  Prints every row's first divergence and gap, and fails on a
    divergence at a wider gap."""
    parts = {}
    for rid, s in sorted(got.items()):
        i = next((j for j, (a, b) in enumerate(zip(s, ref[rid])) if a != b),
                 None)
        if i is None:
            continue
        gap, top2, top = _top2_gap(model, params, prompts[rid] + ref[rid][:i],
                                   dev)
        # a bf16 rounding step at the top logit: 2 ** (exponent - 7)
        step = 2.0 ** (int(np.floor(np.log2(max(abs(top), 1e-30)))) - 7)
        parts[rid] = {"index": i, "spec": s[i:i + 2],
                      "plain": ref[rid][i:i + 2], "plain_top2": top2,
                      "plain_top2_gap": gap, "two_bf16_steps": 2 * step,
                      "near_tie": bool(gap <= 2 * step)}
    res = {"phase": "serve", "run": "qwen_spec_bf16",
           "check": "streams equal to qwen_paged_bf16's, or part only at a "
                    "near-tie of the plain path's top-2 logits",
           "rows_equal": len(got) - len(parts), "rows": len(got),
           "divergences": parts,
           "ok": all(p["near_tie"] for p in parts.values())}
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"qwen_spec_bf16: a stream parts from "
                             f"qwen_paged_bf16's where the plain path's top "
                             f"two logits are not a near-tie: {parts}")
    return res


def serve_targets(dev) -> dict:
    """The speculation targets at full width, cut in depth, in bfloat16,
    weights drawn on the card from the seed: 8 requests of 32-512 tokens,
    ``TARGET_NEW`` new tokens each, through ``PagedServingEngine``.
    qwen2-72b at ``QWEN_LAYERS`` layers: ``qwen_paged_bf16`` (profiled
    over one decode macro-step), ``qwen_spec_bf16`` (K 4 with a model
    draft of smollm-360m's widths at vocab 152064, ``DRAFT_LAYERS``
    layers; a verify round profiled; its streams against
    ``qwen_paged_bf16``'s by ``check_spec_streams``) and
    ``qwen_paged_int8`` / ``qwen_paged_int4`` (each profiled, its share
    of tokens equal to the bf16 run's printed); command-r-35b at
    ``COMMAND_R_LAYERS`` layers: ``command_r_paged_bf16`` (profiled over
    one decode macro-step), its head the tied 256000-row table read in
    place.
    Launches by kernel and body are checked exactly, the draft's too.
    Returns each run's launch counts."""
    import gc
    import torch
    from repro_torch.config import uniform
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import PagedServingEngine
    from repro_torch.serving.speculative import ModelDraft
    launches = {}
    qwen = dataclasses.replace(get_config("qwen2-72b"), n_layers=QWEN_LAYERS,
                               block_pattern=uniform("attn", QWEN_LAYERS))
    kw = dict(max_rows=8, max_len=1024, block_size=16, prefill_chunk=128,
              decode_steps=16, seed=SEED, device=dev)
    prompts = _trace(np.random.default_rng(SEED + 50), 8, 32, 512,
                     qwen.vocab_size)
    res, ref, eng = serve_run("qwen_paged_bf16", PagedServingEngine, qwen,
                              kw, prompts, dev, n_new=TARGET_NEW)
    launches["qwen_paged_bf16"] = res["launches"]
    params = eng.params
    del eng
    profile_decode(qwen, params, kw, dev, label="qwen_paged_bf16")
    draft_cfg = dataclasses.replace(
        get_config("smollm-360m"), vocab_size=qwen.vocab_size,
        n_layers=DRAFT_LAYERS, block_pattern=uniform("attn", DRAFT_LAYERS))
    draft_params = Model(draft_cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED + 7))
    # one draft serves the warm-up engine and the measured one in turn: a
    # proposal re-feeds whatever of a row's history the draft has not seen
    spec_kw = dict(kw, speculative={"k": 4, "provider": ModelDraft(
        draft_cfg, params=draft_params, device=dev)})
    gc.collect()
    torch.cuda.empty_cache()
    res, spec_streams, eng = serve_run(
        "qwen_spec_bf16", PagedServingEngine, qwen, spec_kw, prompts, dev,
        ref=ref, n_new=TARGET_NEW, params=params,
        ref_key="share_equal_to_qwen_paged_bf16")
    launches["qwen_spec_bf16"] = res["launches"]
    if res["verify_rounds"] == 0 or res["launches"][
            "paged_chunk_attention"] != QWEN_LAYERS * res["verify_rounds"]:
        raise AssertionError(f"serve qwen_spec_bf16: {res['verify_rounds']} "
                             f"verify rounds, batched chunk attention "
                             f"launched {res['launches']}")
    check_spec_streams(eng.model, params, prompts, spec_streams, ref, dev)
    del eng
    profile_verify(qwen, params, spec_kw, dev, label="qwen_spec_bf16")
    gc.collect()
    torch.cuda.empty_cache()
    for fmt in ("int8", "int4"):
        name, q_kw = f"qwen_paged_{fmt}", dict(kw, quantization=fmt)
        res, _, eng = serve_run(name, PagedServingEngine, qwen, q_kw,
                                prompts, dev, ref=ref, n_new=TARGET_NEW,
                                params=params)
        launches[name] = res["launches"]
        del eng
        profile_decode(qwen, params, q_kw, dev, label=name)
        gc.collect()
        torch.cuda.empty_cache()
    del params, draft_params, spec_kw
    gc.collect()
    torch.cuda.empty_cache()
    command_r = dataclasses.replace(
        get_config("command-r-35b"), n_layers=COMMAND_R_LAYERS,
        block_pattern=uniform("attn", COMMAND_R_LAYERS))
    res, _, eng = serve_run(
        "command_r_paged_bf16", PagedServingEngine, command_r, kw,
        _trace(np.random.default_rng(SEED + 51), 8, 32, 512,
               command_r.vocab_size), dev, n_new=TARGET_NEW)
    launches["command_r_paged_bf16"] = res["launches"]
    profile_decode(command_r, eng.params, kw, dev,
                   label="command_r_paged_bf16")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _port_kernels(kernels) -> list:
    """The port's own kernels of a profile (each in an anonymous
    namespace of ``csrc/``), by device time: the per-kernel split of a
    window's busy time."""
    return [{"name": e.key[:70], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
            if "anonymous namespace" in e.key]


#: decode iterations in a decode profile window: one macro-step of 8, half
#: the serve runs' K (the profiler's cost grows with the launches it
#: records, and its windows were about half of the serve phase's time)
PROFILE_ITERS = 8


def profile_decode(cfg, params, kw, dev, label: str,
                   prompt_len: int = 257) -> dict:
    """Where decode time goes in one steady macro-step of
    ``PROFILE_ITERS`` decode iterations of 8 rows with prompts of
    ``prompt_len`` tokens (admission, prefill and the first macro-step
    happen before the window; 257 and 1153 prefill whole chunks of 128,
    where 256 would take 8 chunks a row, 128 and the powers of two of
    127).  The window runs twice on identical
    engines: once timed without the profiler (the wall time), once under
    torch.profiler (the device's busy time and the kernels by time).
    The idle share is one minus busy over the unprofiled wall time."""
    t_call = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import PagedServingEngine, Request
    prompts = _trace(np.random.default_rng(SEED + 3), 8, prompt_len,
                     prompt_len, cfg.vocab_size)

    def warm_engine():
        eng = PagedServingEngine(cfg, params,
                                 **dict(kw, decode_steps=PROFILE_ITERS))
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=2 * PROFILE_ITERS))
        eng.step()               # admit + prefill all 8, first macro-step
        torch.cuda.synchronize()
        return eng

    def window(eng):
        t0 = time.perf_counter()
        while eng.active_rows or eng.queue:
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eng = warm_engine()
    t_before, pos0 = eng.t, int(eng.pos.min())
    wall = window(eng)
    iters = eng.t - t_before
    eng = warm_engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = window(eng)
    if eng.t - t_before != iters:
        raise AssertionError("the profiled window ran another number of "
                             "decode iterations")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "profile", "run": label,
           "window": f"decode, 8 rows, pos {pos0}-{pos0 + iters - 1}",
           "decode_iters": iters, "wall_ms": wall * 1e3,
           "wall_profiled_ms": wall_profiled * 1e3,
           "ms_per_decode_iter": wall * 1e3 / iters,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "device_launches": n_launch,
           "device_launches_per_decode_iter": n_launch / iters,
           "top_kernels": [{"name": e.key[:70], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": _port_kernels(kernels),
           "seconds": time.perf_counter() - t_call}
    emit(res)
    return res


def profile_verify(cfg, params, kw, dev, label: str) -> dict:
    """Where a verify round's time goes: two steady rounds of 8 rows
    (admission, prefill and the first round happen before the window),
    timed without the profiler, then again under it on an identical
    engine, as ``profile_decode`` does for macro-steps."""
    t_call = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import PagedServingEngine, Request
    prompts = _trace(np.random.default_rng(SEED + 3), 8, 257, 257,
                     cfg.vocab_size)
    rounds = 2

    def warm_engine():
        eng = PagedServingEngine(cfg, params, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=48))
        eng.step()               # admit + prefill all 8, first round
        torch.cuda.synchronize()
        return eng

    def window(eng):
        t0 = time.perf_counter()
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eng = warm_engine()
    wall = window(eng)
    emitted = eng.tokens_generated
    eng = warm_engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = window(eng)
    if eng.spec_rounds != rounds + 1 or eng.active_rows != 8:
        raise AssertionError("the verify window ran another number of "
                             "rounds or lost a row")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "profile", "run": label,
           "window": f"verify, 8 rows, K {eng.spec.k}, {rounds} rounds",
           "verify_rounds": rounds, "wall_ms": wall * 1e3,
           "wall_profiled_ms": wall_profiled * 1e3,
           "ms_per_round": wall * 1e3 / rounds,
           "tokens_emitted_in_3_rounds": emitted,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_ms_per_round": busy_us / 1e3 / rounds,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "device_launches": n_launch,
           "device_launches_per_round": n_launch / rounds,
           "top_kernels": [{"name": e.key[:70], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": _port_kernels(kernels),
           "seconds": time.perf_counter() - t_call}
    emit(res)
    return res


def profile_prefill(cfg, params, kw, dev, label: str,
                    prompt_len: int = 385, requests: int = 4) -> dict:
    """Where prefill time goes: admission of ``requests`` requests of
    ``prompt_len`` tokens (4 of 385: 12 chunks of 128 at pos 0, 128 and
    256), with no decode.
    As in ``profile_decode``, the window runs once timed without the
    profiler and once under it on an identical engine; the idle share is
    one minus busy over the unprofiled wall time."""
    t_call = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import (PagedServingEngine, Request,
                                            chunk_sizes)
    prompts = _trace(np.random.default_rng(SEED + 6), requests, prompt_len,
                     prompt_len, cfg.vocab_size)
    # a row prefills all of its prompt but the last token
    chunks = sum(len(chunk_sizes(len(p) - 1, kw["prefill_chunk"]))
                 for p in prompts)

    def window():
        eng = PagedServingEngine(cfg, params, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new_tokens=8))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit()             # the prefill of every row, no decode
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    window()                     # warm: allocator pools, first launches
    eng, wall = window()
    if eng.prefill_tokens != sum(len(p) - 1 for p in prompts):
        raise AssertionError("the prefill window did not admit every "
                             "request")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_profiled = window()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    res = {"phase": "profile", "run": label,
           "window": f"prefill, {len(prompts)} requests of "
                     f"{len(prompts[0])} tokens, chunks of "
                     f"{kw['prefill_chunk']}",
           "prefill_chunks": chunks, "wall_ms": wall * 1e3,
           "wall_profiled_ms": wall_profiled * 1e3,
           "ms_per_chunk": wall * 1e3 / chunks,
           "device_busy_ms": busy_us / 1e3,
           "device_busy_ms_per_chunk": busy_us / 1e3 / chunks,
           "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
           "device_launches_per_chunk": sum(e.count for e in kernels) / chunks,
           "top_kernels": [{"name": e.key[:70], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top],
           "port_kernels": _port_kernels(kernels),
           "seconds": time.perf_counter() - t_call}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------
#: the full train run: smollm-360m at full width and depth in bf16, the
#: reference's train_4k sequence on one card's 8 rows, launch/train.py's
#: learning rate (and so its warmup of max(2, steps // 10) = 2)
TRAIN = {"batch": 8, "seq": 4096, "steps": 8, "lr": 3e-3}
#: the rows every norm of a train step takes (the kernels phase holds
#: rmsnorm there)
TRAIN_ROWS = TRAIN["batch"] * TRAIN["seq"]
#: card-vs-CPU parity in float32: full width, 2 layers
#: the card-vs-CPU train cells (smollm's and ``TRAIN_FAMILY_PARITY``'s):
#: 2 steps, each gated on its loss, the first on every gradient and the
#: update (a third step was cut to keep the script inside its time)
TRAIN_PARITY = {"layers": 2, "batch": 2, "seq": 256, "steps": 2}
#: cuBLAS's kernels, by name, in a profile
CUBLAS_KEYS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


#: the body every bf16 train launch of the contiguous flash form takes
#: (``flash_body``'s rule: smollm-360m's and seamless-m4t-medium's hd 64,
#: mixtral-8x7b's and llama-3.2-vision-90b's 128, zamba2-7b's 112)
TRAIN_FLASH_BODY = "wgmma"
#: the body of every bf16 cross read in training: the cross form's wgmma
#: (seamless-m4t-medium's hd 64, llama-3.2-vision-90b's hd 128)
TRAIN_CROSS_BODY = "wgmma"


def _block_norms(kind: str, cfg, enc_cross: bool) -> int:
    """Norms a block runs: ln1, ln_x before an encoder-decoder's cross
    read, ln2 before an MLP (attn, swa and cross blocks)."""
    mlp = kind in ("attn", "swa", "cross") and cfg.mlp_kind != "none"
    return 1 + int(enc_cross and kind in ("attn", "swa")) + int(mlp)


def expected_train_launches(cfg, steps: int) -> tuple:
    """Launches a train run of ``steps`` steps implies.  Every block runs
    its kernels in the forward and again in its checkpoint's recompute in
    the backward pass: a contiguous flash launch for each attn or swa
    block (an encoder's too), two cross-form launches for each cross
    read (a ``cross`` block's, an encoder-decoder's ``enc_xattn``), two
    scan forwards (with checkpoints) for each Mamba block and one scan
    backward; and each block's norms twice, the final norm of each stack
    (the decoder's, an encoder's) once, outside the checkpoints.  The
    first norm of a stack takes no residual add (``norm``: twice a step a
    stack), every other one does (``add_norm``).  Returns (launches by
    kernel, launches by body of the flash form, the cross form, rmsnorm
    and the scan), per ``TRAIN_FLASH_BODY`` / ``TRAIN_CROSS_BODY``."""
    from repro_torch.kernels import _build
    pat = cfg.block_pattern
    enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    n_attn = sum(pat.count(k) for k in ("attn", "swa")) + enc
    n_cross = pat.count("cross") + (
        sum(pat.count(k) for k in ("attn", "swa"))
        if cfg.is_encoder_decoder else 0)
    n_scan = sum(pat.count(k) for k in ("mamba1", "mamba2"))
    stacks = [sum(_block_norms(k, cfg, cfg.is_encoder_decoder)
                  for k in pat)]
    if enc:
        stacks.append(enc * _block_norms("attn", cfg, False))
    norm = 2 * len(stacks)
    add_norm = sum(2 * n - 2 + 1 for n in stacks)
    expect = dict.fromkeys(_build.launches, 0)
    expect["flash_attention"] = 2 * n_attn * steps
    expect["paged_cross_attention"] = 2 * n_cross * steps
    expect["rmsnorm"] = (norm + add_norm) * steps
    expect["selective_scan"] = 2 * n_scan * steps
    expect["selective_scan_backward"] = n_scan * steps
    return expect, {
        "flash_attention": {"wgmma": 0, "mma": 0, "cuda_core": 0,
                            TRAIN_FLASH_BODY: 2 * n_attn * steps},
        "paged_cross_attention": {"wgmma": 0, "mma": 0, "cuda_core": 0,
                                  TRAIN_CROSS_BODY: 2 * n_cross * steps},
        "rmsnorm": {"add_norm": add_norm * steps, "norm": norm * steps,
                    "cuda_core": 0},
        "selective_scan": {"state_lanes": 2 * n_scan * steps,
                           "cuda_core": 0}}


def train_bodies(cfg) -> None:
    """Raise if the wrappers' rules would send ``cfg``'s bf16 train
    launches to other bodies than ``TRAIN_FLASH_BODY`` /
    ``TRAIN_CROSS_BODY`` name."""
    import torch
    from repro_torch.kernels.flash_attention import cross_body, flash_body
    crosses = "cross" in cfg.block_pattern or cfg.is_encoder_decoder
    want = (TRAIN_FLASH_BODY, TRAIN_CROSS_BODY if crosses else None)
    named = (flash_body(torch.bfloat16, cfg.head_dim),
             cross_body(torch.bfloat16, cfg.head_dim) if crosses else None)
    if cfg.n_kv_heads and named != want:
        raise AssertionError(f"{cfg.name}: the rules name the train bodies "
                             f"{named}, expected {want}")


@contextlib.contextmanager
def count_plain_calls():
    """Count, within the block, the calls of the plain versions the train
    path's wrappers take for CPU tensors (none may run on the card)."""
    from repro_torch.kernels import flash_attention, rmsnorm, selective_scan
    sites = [(flash_attention, "flash_attention_plain"),
             (flash_attention, "paged_cross_attention_plain"),
             (rmsnorm, "rmsnorm_plain"), (rmsnorm, "add_rmsnorm_plain"),
             (selective_scan, "selective_scan_plain"),
             (selective_scan, "selective_scan_backward_plain")]
    calls = {name: 0 for _, name in sites}
    saved = [(module, name, getattr(module, name)) for module, name in sites]

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper
    for module, name, fn in saved:
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _frontend(cfg, b: int, dev, seed: int):
    """A seeded frontend (B, src, d_model) in float32 for a config with a
    cross or encoder source, else None: a zero one makes the cross K/V
    and their gradients zero."""
    import torch
    src = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.n_image_tokens
    if not src:
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (b, src, cfg.d_model), dtype=np.float32)).to(dev)


#: the train phase's card-vs-CPU cells of the other families, float32 on
#: the same card-drawn weights: (label, arch, overrides, B, S).  The
#: kernels' widths are the published ones (d_model, heads, head dim,
#: d_inner, d_state, the source lengths); depth is cut as the serve
#: phase's parity cells cut it (mixtral's window 256 as that cell has
#: it), and so that the CPU's side stays near 10 s the vocab to 1024, the
#: MLPs' widths (cuBLAS's, no kernel's: mixtral's experts' moe_d_ff to
#: 256, the dense d_ff to 2048 in zamba2's shared block and 1024 in
#: vision) and vision's depth to its cross layer alone (its attn layer's
#: d_model 8192 doubled the CPU's 19 s); one row (two rows took 108 s of
#: the CPU's for the six cells and the script past 800 s); S 64 crosses
#: a scan checkpoint
TRAIN_FAMILY_PARITY = (
    ("mixtral", "mixtral-8x7b",
     dict(MIXTRAL_PARITY, block_pattern=("swa", "swa"), vocab_size=1024,
          moe_d_ff=256), 1, 64),
    ("falcon_mamba", "falcon-mamba-7b",
     dict(n_layers=2, block_pattern=("mamba1", "mamba1"), vocab_size=1024),
     1, 64),
    ("zamba2", "zamba2-7b",
     dict(n_layers=len(ZAMBA_PARITY), block_pattern=ZAMBA_PARITY,
          vocab_size=1024, d_ff=2048), 1, 64),
    ("vision", VISION_ARCH, dict(CROSS_PARITY[VISION_ARCH], n_layers=1,
                                 block_pattern=("cross",), vocab_size=1024,
                                 d_ff=1024), 1, 64),
    ("seamless", SEAMLESS, dict(CROSS_PARITY[SEAMLESS], vocab_size=1024),
     1, 64))
def family_lr(cfg) -> float:
    """The learning rate of the family cells' steps and of the
    ``TRAIN_RUNS``: 0.1 / d_model (launch/train.py's 3e-3 at smollm's
    d_model 960, scaled as AdamW's first steps need at width: each moves
    every weight by about lr, and a product over d_model inputs then moves
    by about d_model * lr of its size; at 3e-4 vision's d_model 8192 took
    ce from 10.8 to 37 in one step on the H100, and zamba2's and
    falcon-mamba's went back up after a first fall)."""
    return 0.1 / cfg.d_model


def _train_parity_cell(dev, cfg, label, p_cpu, b, s, frontend=None,
                       lr=TRAIN["lr"]) -> dict:
    """Card against CPU in float32 on the same weights ``p_cpu`` (TF32
    off): ``TRAIN_PARITY["steps"]`` steps of ``make_train_step``'s body
    written out (``value_and_grad``, ``cosine_lr`` with a warmup of 2 over 8 steps,
    ``adamw_update``) on each device, the loss held at each step and
    every gradient leaf at the first, where ``adamw_update`` is also fed
    the CPU's gradients on the card (the same update on both devices);
    the later steps' gradient differences are printed.  Neither the
    parameters nor the gradients after a step are held element-wise:
    AdamW's first steps move each weight by about lr * sign(g), so a
    gradient near zero that rounds to the other sign moves its weight by
    2 lr (smollm-360m's cell at lr 3e-3: 1e-6 at the first step's
    gradients, 2.3e-5 at the second's, the losses within 3e-7)."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                                cosine_lr)
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import leaves, tree_map
    t_call = time.perf_counter()
    cpu = Model(cfg, device="cpu")
    card = Model(cfg, device=dev)
    p_dev = tree_map(lambda a: a.to(dev), p_cpu)
    data = SyntheticLM(cfg.vocab_size, s, b, seed=SEED)
    o_cpu, o_dev = adamw_init(p_cpu), adamw_init(p_dev)
    losses, grad_errs, aux, upd_err = [], [], {}, None
    for i in range(TRAIN_PARITY["steps"]):
        batch = {"tokens": torch.from_numpy(data.batch_at(i)["tokens"])}
        if frontend is not None:
            batch["frontend"] = frontend
        l_cpu, m_cpu, g_cpu = value_and_grad(cpu, p_cpu, batch)
        l_dev, m_dev, g_dev = value_and_grad(
            card, p_dev, {k: v.to(dev) for k, v in batch.items()})
        losses.append([float(l_cpu), float(l_dev)])
        grad_errs.append(_grad_err([g.cpu() for g in leaves(g_dev)],
                                   leaves(g_cpu)))
        aux = aux or {k: [float(m_cpu[k]), float(m_dev[k])]
                      for k in ("moe_aux_loss", "moe_drop_frac")}
        lr_i = cosine_lr(o_cpu.step, lr, 2, 8)
        new_cpu = adamw_update(g_cpu, o_cpu, p_cpu, lr=lr_i)
        if i == 0:
            same = adamw_update(tree_map(lambda a: a.to(dev), g_cpu), o_dev,
                                p_dev, lr=lr_i.to(dev))
            upd_err = max((a.cpu().float() - c.float()).abs().max().item()
                          for a, c in zip(leaves(same[:2]),
                                          leaves(new_cpu[:2])))
            del same
        p_cpu, o_cpu, _ = new_cpu
        p_dev, o_dev, _ = adamw_update(g_dev, o_dev, p_dev,
                                       lr=cosine_lr(o_dev.step, lr, 2, 8))
        del g_cpu, g_dev, new_cpu
    loss_rel = max(abs(d - c) / abs(c) for c, d in losses)
    res = {"phase": "train", "check": "card vs CPU, float32",
           "config": f"{label}, float32, B {b}, S {s}, lr {lr}",
           "grad_max_rel_err_by_step": grad_errs,
           "moe_aux_cpu_card": aux, "adamw_same_grads_max_abs_err": upd_err,
           "losses_cpu_card": losses, "loss_max_rel_err": loss_rel,
           "tol": {"loss": 1e-5, "grad": 1e-5, "adamw": 1e-6},
           "seconds": time.perf_counter() - t_call}
    emit(res)
    if not (loss_rel <= 1e-5 and grad_errs[0] <= 1e-5 and upd_err <= 1e-6):
        raise AssertionError(f"train parity: card and CPU disagree: {res}")
    return res


def train_parity(dev) -> list:
    """Card against CPU in float32 (``_train_parity_cell``): smollm-360m at
    full width, 2 layers, B 2, S 256, weights drawn on the CPU, at
    launch/train.py's learning rate; then each family of
    ``TRAIN_FAMILY_PARITY`` on card-drawn weights (the cross families
    with a seeded frontend) at ``family_lr``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    n, b, s = (TRAIN_PARITY[k] for k in ("layers", "batch", "seq"))
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=n,
                              block_pattern=("attn",) * n, dtype="float32")
    out = [_train_parity_cell(
        dev, cfg, f"{cfg.name}, {n} layers", Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED)), b, s)]
    for i, (label, arch, over, b, s) in enumerate(TRAIN_FAMILY_PARITY):
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
        cuts = ", ".join(f"{k} {v}" for k, v in over.items()
                         if k != "block_pattern")
        out.append(_train_parity_cell(
            dev, cfg, f"{arch}, {cfg.block_pattern}, {cuts}",
            _card_drawn(cfg, dev), b, s,
            _frontend(cfg, b, "cpu", SEED + 40 + i), family_lr(cfg)))
    return out


#: the bf16 full-width train runs beside smollm-360m's ``train_bf16``,
#: with f32 AdamW state: (run, arch, overrides, B, S, profiled).  Widths
#: are the published ones; depth (and vision's vocab) cut so weights,
#: bf16 gradients and both AdamW states fit the card twice over while
#: the functional update holds the old and the new state at once:
#: mixtral 1 of 32 layers (1.7 B params; 2 layers would need about 88
#: GB at the update), falcon-mamba 8 of 64, zamba2 four layers (two
#: mamba2, two positions of the shared attn block), vision one attn and
#: one cross layer with vocab 128256 cut to 32000 (3.8 B params uncut
#: would need about 84 GB), seamless uncut
TRAIN_RUNS = (
    ("mixtral_train_bf16", "mixtral-8x7b",
     dict(n_layers=1, block_pattern=("swa",)), 2, 2048, False),
    ("mamba_train_bf16", "falcon-mamba-7b",
     dict(n_layers=8, block_pattern=("mamba1",) * 8), 2, 2048, True),
    ("zamba_train_bf16", "zamba2-7b",
     dict(n_layers=len(ZAMBA_PARITY), block_pattern=ZAMBA_PARITY), 2, 2048,
     False),
    ("vision_train_bf16", VISION_ARCH,
     dict(n_layers=2, block_pattern=("attn", "cross"), vocab_size=32000), 2,
     512, True),
    ("seamless_train_bf16", SEAMLESS, {}, 2, 512, False))
#: steps of each of those runs
TRAIN_RUN_STEPS = 4


#: what the train phase measured that a later phase reads: run name ->
#: {"max_memory_allocated", "flop_counter"}
MEASURED: dict = {}


def train_run(dev, name, arch, overrides, b, s, steps, profiled,
              lr=None, count_flops: bool = False) -> dict:
    """``steps`` steps of ``arch`` at full width in its dtype (bf16), f32
    AdamW state, at B ``b``, S ``s`` and learning rate ``lr`` (by default
    ``family_lr``; warmup max(2, steps // 10)) through
    ``launch/train.py``'s setup
    (weights from a card Generator seeded 0, batches from
    ``SyntheticLM(seed=0)``; a cross family's frontend seeded), one JSON
    line a step (ce, grad norm, lr, wall ms, tokens/s, peak memory).
    Gates: every ce finite, the last below the first; the launches and
    bodies exactly as ``expected_train_launches`` says; no plain version
    run.  ``profiled``: one more step under torch.profiler, with the
    device's busy ms (and idle share against the steady steps' median
    wall time), each port kernel's ms, the torch-op backwards' (the
    flash form's, the cross form's), cuBLAS's and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.configs import get_config
    from repro_torch.launch.train import device_batch, setup
    from repro_torch.training.tree import leaves
    t_call = time.perf_counter()
    if lr is None:
        lr = family_lr(dataclasses.replace(get_config(arch),
                                           **(overrides or {})))
    cfg, model, params, opt, step, data = setup(
        arch, smoke=False, steps=steps, batch=b, seq=s, lr=lr, device=dev,
        overrides=overrides)
    train_bodies(cfg)
    frontend = _frontend(cfg, b, dev, SEED + 50)
    batches = []
    for i in range(steps + 1):
        batch = device_batch(data, i, dev)
        if frontend is not None:
            batch["frontend"] = frontend
        batches.append(batch)
    torch.cuda.synchronize()
    rows = []
    _build.reset_launches()
    with count_plain_calls() as plain_calls:
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batches[i])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows.append({"phase": "train", "run": name, "step": i,
                         "ce": float(m["ce"]),
                         "moe_aux_loss": float(m["moe_aux_loss"]),
                         "moe_drop_frac": float(m["moe_drop_frac"]),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "wall_ms": wall * 1e3,
                         "tok_per_s": b * s / wall,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(dev)})
            emit(rows[-1])
    launches = dict(_build.launches)
    bodies = {k: dict(_build.bodies[k]) for k in (
        "flash_attention", "paged_cross_attention", "rmsnorm",
        "selective_scan")}
    expect, expect_bodies = expected_train_launches(cfg, steps)
    ces = [r["ce"] for r in rows]
    walls = sorted(r["wall_ms"] for r in rows[1:])
    wall_ref = walls[len(walls) // 2]
    n_params = sum(p.numel() for p in leaves(params))
    res = {"phase": "train", "run": name, "lr": lr,
           "config": f"{cfg.name}, {cfg.n_layers} layers "
                     f"{cfg.block_pattern if cfg.n_layers <= 4 else ''}, "
                     f"{cfg.dtype}, vocab {cfg.vocab_size}, B {b}, S {s}, "
                     f"f32 AdamW state",
           "params": n_params, "steps": steps, "ce": ces,
           "wall_ms_median": wall_ref,
           "tok_per_s_median": b * s / (wall_ref / 1e3),
           "max_memory_allocated": max(r["max_memory_allocated"]
                                       for r in rows),
           "launches": launches, "launches_expected": expect,
           "bodies": bodies, "bodies_expected": expect_bodies,
           "plain_calls": plain_calls}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batches[steps])
            torch.cuda.synchronize()
            wall_profiled = time.perf_counter() - t0
        res["profile"] = train_profile(prof.key_averages(), wall_ref,
                                       wall_profiled)
    if count_flops:
        # one more step under FlopCounterMode: torch's matrix products
        # only (the kernels launch through ctypes, which it cannot see)
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as fc:
            params, opt, m = step(params, opt, batches[steps])
            torch.cuda.synchronize()
        res["flop_counter"] = fc.get_total_flops()
    MEASURED[name] = {k: res.get(k) for k in ("max_memory_allocated",
                                              "flop_counter")}
    res["seconds"] = time.perf_counter() - t_call
    emit(res)
    del params, opt, step, model
    if not (all(np.isfinite(ces)) and ces[-1] < ces[0]):
        raise AssertionError(f"{name}: ce {ces}: not finite, or not "
                             f"falling")
    if launches != expect or bodies != expect_bodies:
        raise AssertionError(f"{name}: launches {launches}, bodies "
                             f"{bodies}; expected {expect}, "
                             f"{expect_bodies}")
    if any(plain_calls.values()):
        raise AssertionError(f"{name}: plain versions ran on the card: "
                             f"{plain_calls}")
    return launches


#: profiler labels of the torch-op backwards (record_function ranges:
#: their device time is that of the kernels launched under them)
TRAIN_BWD_LABELS = ("flash_attention_backward", "cross_attention_backward")


def train_profile(events, wall_ref: float, wall_profiled: float) -> dict:
    """A profiled train step: device busy ms and idle share (against the
    steady steps' median wall ms), launches, each port kernel's ms, the
    torch-op backwards' device ms by label, cuBLAS's ms, top kernels."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda
               and e.key not in TRAIN_BWD_LABELS
               and e.key != "selective_scan_backward"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")

    def ms_of(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / 1e3
    return {
        "wall_profiled_ms": wall_profiled * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e3 / wall_ref,
        "device_launches": sum(e.count for e in kernels),
        "flash_kernel_ms": ms_of(lambda k: "flash_wgmma_kernel" in k
                                 or "flash_mma_kernel" in k
                                 or "flash_core_kernel" in k),
        "cross_kernel_ms": ms_of(lambda k: "cross" in k and "kernel" in k),
        "rmsnorm_kernel_ms": ms_of(lambda k: "add_norm_kernel" in k
                                   or "rmsnorm" in k),
        "scan_forward_ms": ms_of(lambda k: "scan_lanes_kernel" in k),
        "scan_backward_ms": ms_of(lambda k: "scan_backward" in k),
        "torch_op_backward_ms": {
            label: [e.device_time_total / 1e3 for e in events
                    if e.key == label] for label in TRAIN_BWD_LABELS},
        "torch_op_backward_note": "device time of the kernels launched "
                                  "under each label (torch ops), by "
                                  "event kind",
        "cublas_ms": ms_of(lambda k: any(x in k.lower()
                                         for x in CUBLAS_KEYS)),
        "top_kernels": [{"name": e.key[:70], "count": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in sorted(kernels, key=lambda e:
                                        -e.self_device_time_total)[:10]],
        "port_kernels": _port_kernels(kernels)}


def train_full(dev) -> dict:
    """smollm-360m at full width and depth (32 layers) in bf16, f32 AdamW
    state: ``TRAIN["steps"]`` steps at B 8, S 4096 through
    ``train_run``, profiled (every flash launch on ``wgmma``)."""
    return train_run(dev, "train_bf16", "smollm-360m", None, TRAIN["batch"],
                     TRAIN["seq"], TRAIN["steps"], True, lr=TRAIN["lr"],
                     count_flops=True)


def train(dev) -> dict:
    """The train phase: ``train_parity`` (smollm-360m and every family),
    then ``train_full`` and the ``TRAIN_RUNS``.  Returns each full run's
    launch counts by run name."""
    import gc
    import torch
    train_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"train_bf16": train_full(dev)}
    for name, arch, over, b, s, profiled in TRAIN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = train_run(dev, name, arch, over, b, s, TRAIN_RUN_STEPS,
                              profiled)
    return out


# ---------------------------------------------------------------------------
# phase 7: scale -- the scale-out plane on four gloo ranks on the one card
# ---------------------------------------------------------------------------
#: ranks of the scale phase: four processes on cuda:0 over gloo (NCCL
#: places no two ranks on one card; gloo all-reduces CUDA tensors)
SCALE_WORLD = 4
#: the seq-parallel decode at decode_32k's S (repro_torch/config.py) and
#: 8 rows: (label, the config whose heads it takes, mesh, dtype)
SCALE_S, SCALE_B = 32768, 8
SCALE_DECODE = (("smollm_f32", "smollm-360m", "2x2", "float32"),
                ("smollm_bf16", "smollm-360m", "2x2", "bfloat16"),
                ("qwen_bf16", "qwen2-72b", "1x4", "bfloat16"))
#: logical positions of the 8 rows: on the 2x2 mesh (S_loc 16384) rows
#: 0, 1 and 5 leave the second model shard empty, rows 4 and 7 fill it
#: (7 past the cache), row 2 puts one slot in it
SCALE_POS = [100, 16383, 16384, 20000, 32767, 5000, 31000, 40000]
#: the sharded MoE at full width over SCALE_TOKENS tokens on the 1x4
#: mesh: (label, config, form)
SCALE_TOKENS = 1024
SCALE_MOE = (("kimi_sharded", "kimi-k2-1t-a32b", "sharded"),
             ("mixtral_capsharded", "mixtral-8x7b", "capsharded"))
#: the f32 cell at the CPU tests' widths (tests/test_torch_distributed.py):
#: decode B 4, 8/2 heads of 64, S 256; the MoE at the mixtral smoke
#: config's widths with E 4 (sharded) and E 3 (capsharded), capacity
#: factor 0.5, 4 x 32 tokens
SCALE_SMALL_DECODE = {"B": 4, "H": 8, "KV": 2, "S": 256, "hd": 64,
                      "pos": [3, 100, 255, 17]}
SCALE_SMALL_MOE = (("sharded", 4), ("capsharded", 3))
SCALE_CARD_CPU_TOL = 1e-5
#: device_ms calls a timing turn of the partials kernel takes
SCALE_TIMED_CALLS = 10


def _scale_meshes(device_type: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    return {name: init_device_mesh(device_type, shape,
                                   mesh_dim_names=("data", "model"))
            for name, shape in (("2x2", (2, 2)), ("1x4", (1, 4)))}


def _scale_expert(cfg, e: int, dev) -> tuple:
    """Expert ``e``'s (w_gate, w_up, w_down) in bf16, drawn from a
    generator seeded by (SEED, e) alone, so a rank draws only its own
    experts and the single-process oracle the same values; scaled as
    ``moe_init`` scales them (E ** -0.5, the reference's fan-in of (E, in,
    out))."""
    import torch
    from repro_torch.models.layers import _dense_init
    gen = torch.Generator(device=dev).manual_seed((SEED << 20) + e)
    d, f = cfg.d_model, cfg.moe_d_ff_eff
    s = cfg.n_experts ** -0.5
    return tuple(_dense_init(gen, shape, torch.bfloat16, dev, scale=s)
                 for shape in ((d, f), (d, f), (f, d)))


def _scale_moe_inputs(cfg, dev, experts) -> tuple:
    """(params, x) of a full-width MoE layer: the f32 router and x (1,
    SCALE_TOKENS, d_model) in bf16 from fixed seeds (the same on every
    rank), the experts ``experts`` stacked."""
    import torch
    from repro_torch.models.layers import _dense_init
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    router = _dense_init(gen, (cfg.d_model, cfg.n_experts), torch.float32,
                         dev)
    x = torch.randn((1, SCALE_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    d, f, n = cfg.d_model, cfg.moe_d_ff_eff, len(experts)
    params = {"router": router,
              "we_gate": torch.empty((n, d, f), dtype=torch.bfloat16,
                                     device=dev),
              "we_up": torch.empty((n, d, f), dtype=torch.bfloat16,
                                   device=dev),
              "we_down": torch.empty((n, f, d), dtype=torch.bfloat16,
                                     device=dev)}
    for i, e in enumerate(experts):
        for name, w in zip(("we_gate", "we_up", "we_down"),
                           _scale_expert(cfg, e, dev)):
            params[name][i] = w
    return params, x


def _partials_errors(got, want) -> dict:
    """The partials gate (as tests/test_torch_kernels.py's cuda test): m
    and l within SCALE tolerance of max(1, |value|), acc / l (the
    output's scale) absolutely, an empty row exactly (acc 0, l 0, m
    NEG_INF)."""
    import torch
    from repro_torch.kernels.decode_attention import NEG_INF
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    empty = l_p == 0
    exact = (torch.equal(empty, l == 0)
             and bool((m[empty] == NEG_INF).all())
             and bool((acc[empty.expand_as(acc)] == 0).all()))
    return {"m": ((m - m_p).abs() / m_p.abs().clamp(min=1)).max().item(),
            "l": ((l - l_p).abs() / l_p.abs().clamp(min=1)).max().item(),
            "acc_over_l": (acc / l.clamp(min=1e-30)
                           - acc_p / l_p.clamp(min=1e-30)).abs().max().item(),
            "empty_rows": int(empty[:, 0, 0].sum().item()),
            "empty_exact": exact}


def _scale_small(dev, meshes) -> dict:
    """The f32 cell: every form at the CPU tests' widths on the card and
    on CPU tensors through the same gloo groups; card = CPU within
    SCALE_CARD_CPU_TOL (aux and drops too, drops exactly)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import (moe_apply_capsharded,
                                        moe_apply_sharded)
    from repro_torch.serving.decode import (decode_specs,
                                            distributed_decode_attention)
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.specs import local_shard
    rng = np.random.default_rng(SEED + 43)
    c = SCALE_SMALL_DECODE
    q = torch.from_numpy(rng.standard_normal((c["B"], c["H"], c["hd"]),
                                             dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal(
        (c["B"], c["S"], c["KV"], c["hd"]), dtype=np.float32))
        for _ in range(2))
    pos = torch.tensor(c["pos"], dtype=torch.int32)
    out = {}
    for name, mesh in meshes.items():
        specs = decode_specs(mesh)
        got = {}
        for where in ("cpu", dev):
            args = [local_shard(a, s, mesh).contiguous().to(where)
                    for a, s in zip((q, k, v, pos), (specs[0], specs[1],
                                                     specs[1], specs[2]))]
            got[str(where)] = distributed_decode_attention(*args, mesh)
        out[f"decode_{name}"] = (got[str(dev)].cpu()
                                 - got["cpu"]).abs().max().item()
    base = get_smoke_config("mixtral-8x7b")
    mesh = meshes["2x2"]
    for form, e in SCALE_SMALL_MOE:
        cfg = dataclasses.replace(base, n_experts=e, experts_per_token=2,
                                  capacity_factor=0.5)
        d, f = cfg.d_model, cfg.moe_d_ff_eff
        params = {"router": rng.standard_normal((d, e)) * d ** -0.5,
                  "we_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
                  "we_up": rng.standard_normal((e, d, f)) * d ** -0.5,
                  "we_down": rng.standard_normal((e, f, d)) * f ** -0.5}
        params = {n: torch.from_numpy(w.astype(np.float32))
                  for n, w in params.items()}
        if form == "sharded":
            for n in ("we_gate", "we_up", "we_down"):
                params[n] = local_shard(params[n], P("model", None, None),
                                        mesh).contiguous()
        x = local_shard(torch.from_numpy(rng.standard_normal(
            (4, 32, d), dtype=np.float32)), P("data", None, None), mesh)
        fn = moe_apply_sharded if form == "sharded" else moe_apply_capsharded
        (y_c, aux_c), (y_g, aux_g) = (
            fn({n: w.to(where) for n, w in params.items()},
               x.to(where), cfg, mesh) for where in ("cpu", dev))
        out[f"moe_{form}"] = max(
            [(y_g.cpu() - y_c).abs().max().item()]
            + [abs(float(aux_g[n]) - float(aux_c[n]))
               for n in ("moe_aux_loss", "moe_drop_frac")])
        out[f"moe_{form}_drop_equal"] = (float(aux_g["moe_drop_frac"])
                                         == float(aux_c["moe_drop_frac"]))
        out[f"moe_{form}_drop"] = float(aux_c["moe_drop_frac"])
    return out


def _scale_decode_inputs(dev, meshes) -> list:
    """The full-width decode cases: the whole q, caches and pos drawn
    from one seed on every rank, and this rank's slices of them."""
    import torch
    from repro_torch.serving.decode import decode_specs
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.specs import local_shard
    cases = []
    for label, arch, mesh_name, dname in SCALE_DECODE:
        mesh = meshes[mesh_name]
        dtype = getattr(torch, dname)
        h, kv, hd = VERIFY_HEADS[arch]
        gen = torch.Generator(device=dev).manual_seed(SEED + 47)
        q, kc, vc = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((SCALE_B, h, hd), (SCALE_B, SCALE_S, kv, hd),
                                   (SCALE_B, SCALE_S, kv, hd)))
        pos = torch.tensor(SCALE_POS, dtype=torch.int32, device=dev)
        qs, cs, ps = decode_specs(mesh)
        rows = P(qs[0], None, None, None)     # this rank's rows, every slot
        s_loc = SCALE_S // dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        cases.append({
            "label": label, "arch": arch, "mesh": mesh_name, "dtype": dname,
            "H": h, "KV": kv, "hd": hd, "s_loc": s_loc,
            "s_start": mesh.get_local_rank("model") * s_loc,
            "local": [local_shard(a, s, mesh).contiguous() for a, s in
                      ((q, qs), (kc, cs), (vc, cs), (pos, ps))],
            "rows": [local_shard(a, s, mesh).contiguous() for a, s in
                     ((q, qs), (kc, rows), (vc, rows), (pos, ps))]})
        del q, kc, vc
    return cases


def _scale_decode(dev, meshes, rank: int) -> dict:
    """The seq-parallel decode at full width.  The main path (every
    count reset just before, read just after): ``distributed_decode_
    attention`` on each of SCALE_DECODE's cases, the partials form once
    a case (f32 on cuda_core, bf16 on mma).  Then the gates on this
    rank's rows: the distributed output against one-rank
    ``dense_decode_attention`` over the whole cache and against its
    plain version (TOL, bf16 two steps too), the rank's partials
    against the plain partials.  Then the timings: the partials kernel,
    its library call and its plain version in turns on rank 0 alone (the
    other ranks wait at a barrier), and the combine's three all-reduces
    on every rank (host clock, gloo through the host: printed, not
    gated)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention, dense_decode_attention_partial,
        dense_decode_attention_partial_plain, dense_decode_attention_plain)
    from repro_torch.serving.decode import distributed_decode_attention
    cases = _scale_decode_inputs(dev, meshes)
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [distributed_decode_attention(*c["local"], meshes[c["mesh"]])
            for c in cases]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    bodies = dict(_build.bodies["dense_decode_attention_partial"])
    res = {"launches": launches, "bodies": bodies, "cases": []}
    for c, out in zip(cases, outs):
        ql, kl, vl, pl = c["local"]
        qr, kr, vr, pr = c["rows"]
        one = dense_decode_attention(qr, kr, vr, pr)
        plain = dense_decode_attention_plain(qr, kr, vr, pr)
        row = {"label": c["label"]}
        for name, ref in (("one_rank", one), ("plain", plain)):
            err, rel, excess, ok = _errors(out, ref, c["dtype"], TOL, False)
            row[name] = {"max_abs_err": err, "bf16_step_excess": excess,
                         "ok": ok}
        got = dense_decode_attention_partial(ql, kl, vl, pl, c["s_start"])
        want = dense_decode_attention_partial_plain(ql, kl, vl, pl,
                                                    c["s_start"])
        part = _partials_errors(got, want)
        part["ok"] = (part["empty_exact"] and max(
            part["m"], part["l"], part["acc_over_l"]) <= TOL["float32"])
        row["partials"] = part
        row["finite"] = bool(torch.isfinite(out).all())
        res["cases"].append(row)
    # the combine's collectives alone, on every rank
    for c in cases:
        b, h, hd = c["local"][0].shape
        acc = torch.ones((b, h, hd), device=dev)
        m, l = (torch.ones((b, h, 1), device=dev) for _ in range(2))
        group = meshes[c["mesh"]].get_group("model")
        for _ in range(2):
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SCALE_TIMED_CALLS):
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
        torch.cuda.synchronize()
        res.setdefault("combine_ms", {})[c["label"]] = (
            (time.perf_counter() - t0) * 1e3 / SCALE_TIMED_CALLS)
    dist.barrier()
    if rank == 0:
        res["timing"] = [_scale_decode_timing(c) for c in cases]
    dist.barrier()
    return res


def _scale_decode_timing(c) -> dict:
    """Rank 0's partials kernel on its slice in turns with the library
    call (``_scaled_dot_product_efficient_attention`` with the log-sum-exp,
    which returns the same partial; K/V repeated to every query head, a
    float mask) and the plain version: kernel, library, plain, plain,
    library, kernel; also SDPA with a boolean mask and ``enable_gqa``,
    and the kernel per back-to-back call.  Bound: the bytes of the valid
    slots' K and V (the kernel reads no other), q, the partials and pos;
    4 * H * hd operations a valid slot."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention_partial, dense_decode_attention_partial_plain)
    ql, kl, vl, pl = c["local"]
    b, h, hd = ql.shape
    s_loc, kv, s0 = c["s_loc"], c["KV"], c["s_start"]
    es = ql.element_size()
    valid = int((pl.long().cpu() - s0 + 1).clamp(0, s_loc).sum())
    nbytes = (2 * valid * kv * hd * es + b * h * hd * es
              + b * h * (hd + 2) * 4 + 4 * b)
    flops = 4 * h * hd * valid
    kg = kl.permute(0, 2, 1, 3).repeat_interleave(h // kv, dim=1).contiguous()
    vg = vl.permute(0, 2, 1, 3).repeat_interleave(h // kv, dim=1).contiguous()
    ok = (s0 + torch.arange(s_loc, device=ql.device)[None, :]
          <= pl.long()[:, None])                               # (B, S_loc)
    bias = torch.where(ok, 0.0, -1e30).to(ql.dtype)[:, None, None, :].expand(
        b, h, 1, s_loc).contiguous()
    q4 = ql[:, :, None, :]

    def kernel():
        return dense_decode_attention_partial(ql, kl, vl, pl, s0)

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q4, kg, vg, bias, True)

    def plain():
        return dense_decode_attention_partial_plain(ql, kl, vl, pl, s0)
    n = SCALE_TIMED_CALLS
    turns = [device_ms(f, n=n) for f in (kernel, library, plain, plain,
                                         library, kernel)]
    b_ms, b_by = bound(nbytes, flops, c["dtype"])
    got, want = kernel(), plain()
    return {"label": c["label"], "kernel": "dense_decode_attention_partial",
            "dtype": c["dtype"],
            "shape": {"model": c["arch"], "mesh": c["mesh"], "B": b, "H": h,
                      "KV": kv, "hd": hd, "S": SCALE_S, "S_loc": s_loc,
                      "s_start": s0, "pos": SCALE_POS},
            "body": "mma" if c["dtype"] == "bfloat16" else "cuda_core",
            "max_abs_err": (got[0] / got[2].clamp(min=1e-30) - want[0]
                            / want[2].clamp(min=1e-30)).abs().max().item(),
            "ms": (turns[0] + turns[5]) / 2, "prev_ms": None,
            "library_ms": (turns[1] + turns[4]) / 2,
            "plain_ms": (turns[2] + turns[3]) / 2, "turns_ms": turns,
            "library_note": "torch.ops.aten._scaled_dot_product_efficient_"
                            "attention(compute_log_sumexp=True) over the "
                            "slice, K/V repeated to the query heads",
            "library_sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
                q4, kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3),
                attn_mask=ok[:, None, None, :], enable_gqa=True), n=n),
            "call_ms": call_ms(kernel, n=2 * n),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes_whole_slice": 2 * b * kv * s_loc * hd * es,
            "valid_slots": valid, "bytes": nbytes, "flops": flops}


def _scale_moe(dev, meshes, rank: int, out_dir: str) -> dict:
    """The sharded MoE at full width on the 1x4 mesh: kimi-k2's 384
    experts through ``moe_apply_sharded`` (each rank draws and holds only
    its 96, 8.46 GB), then mixtral-8x7b's 8 through
    ``moe_apply_capsharded`` (every rank all 8, its quarter of each
    one's places), SCALE_TOKENS tokens each.  Each rank's local part
    (``moe_*_local``, no collective) runs once under
    ``torch.cuda.set_sync_debug_mode("error")``; each form's y is saved
    for the parent's single-process oracle; rank 0 reads nvidia-smi's
    memory while every rank holds its experts."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    mesh = meshes["1x4"]
    n_model = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    r = mesh.get_local_rank("model")
    res = {}
    for label, arch, form in SCALE_MOE:
        cfg = get_config(arch)
        e_loc = cfg.n_experts // n_model if form == "sharded" else None
        experts = (range(r * e_loc, (r + 1) * e_loc) if e_loc
                   else range(cfg.n_experts))
        params, x = _scale_moe_inputs(cfg, dev, experts)
        local = moe.moe_sharded_local if e_loc else moe.moe_capsharded_local
        apply = moe.moe_apply_sharded if e_loc else moe.moe_apply_capsharded
        local(params, x, cfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            local(params, x, cfg, mesh)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dist.barrier()
        smi = None
        if rank == 0:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,memory.used,"
                 "memory.total", "--format=csv,noheader"],
                capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        dist.barrier()
        t0 = time.perf_counter()
        y, aux = apply(params, x, cfg, mesh)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.save(y.cpu(), os.path.join(out_dir, f"{label}_rank{rank}.pt"))
        res[label] = {"experts_held": len(experts),
                      "expert_bytes": sum(params[n].numel()
                                          * params[n].element_size()
                                          for n in ("we_gate", "we_up",
                                                    "we_down")),
                      "moe_aux_loss": float(aux["moe_aux_loss"]),
                      "moe_drop_frac": float(aux["moe_drop_frac"]),
                      "finite": bool(torch.isfinite(y).all()),
                      "wall_ms": wall_ms, "nvidia_smi": smi,
                      "no_host_sync": True}
        del params, x, y
        gc.collect()
        torch.cuda.empty_cache()
    return res


def scale_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the scale phase (spawned): a gloo world of SCALE_WORLD
    through a FileStore, a 2x2 and a 1x4 mesh, the f32 cell, the decode
    and the MoE; its record into ``out_dir/rank{rank}.json``."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import _build
    _build.library()                 # the parent's build, loaded
    dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                         SCALE_WORLD),
                            rank=rank, world_size=SCALE_WORLD)
    meshes = _scale_meshes("cuda")
    rec = {"rank": rank,
           "coords": {k: list(m.get_coordinate()) for k, m in meshes.items()}}
    rec["small"] = _scale_small(dev, meshes)
    rec["decode"] = _scale_decode(dev, meshes, rank)
    torch.cuda.empty_cache()
    rec["moe"] = _scale_moe(dev, meshes, rank, out_dir)
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def _scale_oracle(dev, out_dir: str) -> list:
    """After the ranks exit: the port's single-process ``moe_apply`` over
    every expert of each SCALE_MOE layer (kimi-k2: all 384, 33.8 GB) on
    the same tokens, against each rank's y (TOL in bf16, two bf16 steps)
    and drop fraction (exactly)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply
    rows = []
    for label, arch, form in SCALE_MOE:
        cfg = get_config(arch)
        params, x = _scale_moe_inputs(cfg, dev, range(cfg.n_experts))
        t0 = time.perf_counter()
        y, aux = moe_apply(params, x, cfg)
        torch.cuda.synchronize()
        row = {"label": label, "form": form, "oracle_wall_ms":
               (time.perf_counter() - t0) * 1e3,
               "oracle_expert_bytes": sum(params[n].numel()
                                          * params[n].element_size()
                                          for n in ("we_gate", "we_up",
                                                    "we_down")),
               "moe_drop_frac": float(aux["moe_drop_frac"]),
               "moe_aux_loss": float(aux["moe_aux_loss"]), "ranks": []}
        for r in range(SCALE_WORLD):
            got = torch.load(os.path.join(out_dir, f"{label}_rank{r}.pt")
                             ).to(dev)
            err, _, excess, ok = _errors(got, y, "bfloat16", TOL, False)
            row["ranks"].append({"max_abs_err": err,
                                 "bf16_step_excess": excess, "ok": ok})
        rows.append(row)
        del params, x, y
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def scale(dev) -> dict:
    """The scale phase: SCALE_WORLD ranks spawned once (spawn: this
    process holds a CUDA context) on cuda:0 over gloo, the kernel library
    built here first so they only load it.  Gates: the f32 cell card =
    CPU; each decode case's output against one-rank
    ``dense_decode_attention`` and the plain version, each rank's
    partials against the plain partials, an empty model shard in the
    2x2 cases; the partials form launched once a case on the main path,
    f32 on cuda_core and bf16 on mma; the MoE forms free of host syncs,
    finite, and equal to the single-process oracle (``_scale_oracle``).
    Then ``python -m repro_torch.launch.serve`` at its defaults on the
    card: exit 0, every request done.  Returns (the main path's
    launches on rank 0, the timing cases)."""
    import gc
    import tempfile
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(scale_rank, args=(os.path.join(tmp, "store"), tmp),
                           nprocs=SCALE_WORLD, join=True,
                           start_method="spawn")
        ranks_s = time.perf_counter() - t0
        recs = []
        for r in range(SCALE_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        oracle = _scale_oracle(dev, tmp)
    bad = []
    for rec in recs:
        small = rec["small"]
        emit({"phase": "scale", "check": "f32 cell, card = CPU",
              "rank": rec["rank"], "coords": rec["coords"], **small})
        if not all(small[k] <= SCALE_CARD_CPU_TOL for k in small
                   if k.startswith(("decode_", "moe_"))
                   and not k.endswith(("_drop_equal", "_drop"))) or not all(
                small[f"moe_{f}_drop_equal"] for f, _ in SCALE_SMALL_MOE):
            bad.append(f"rank {rec['rank']}: f32 cell card != CPU {small}")
        dec = rec["decode"]
        emit({"phase": "scale", "rank": rec["rank"],
              "peak_gb": rec["peak_gb"], "launches": {
                  "dense_decode_attention_partial":
                      dec["launches"]["dense_decode_attention_partial"]},
              "bodies": dec["bodies"], "combine_ms": dec["combine_ms"],
              "cases": dec["cases"], "moe": rec["moe"]})
        want_bodies = {"mma": 2, "cuda_core": 1}
        others = {k: n for k, n in dec["launches"].items()
                  if n and k != "dense_decode_attention_partial"}
        if dec["bodies"] != want_bodies or others or dec["launches"][
                "dense_decode_attention_partial"] != len(SCALE_DECODE):
            bad.append(f"rank {rec['rank']}: main-path launches "
                       f"{dec['launches']}, bodies {dec['bodies']}; want "
                       f"{len(SCALE_DECODE)} partials launches, "
                       f"{want_bodies}")
        for row in dec["cases"]:
            if not (row["one_rank"]["ok"] and row["plain"]["ok"]
                    and row["partials"]["ok"] and row["finite"]):
                bad.append(f"rank {rec['rank']} {row['label']}: {row}")
        for label, m in rec["moe"].items():
            if not m["finite"]:
                bad.append(f"rank {rec['rank']} {label}: non-finite y")
    for label, _, mesh, _ in SCALE_DECODE:
        empty = [row["partials"]["empty_rows"] for rec in recs
                 for row in rec["decode"]["cases"] if row["label"] == label]
        if mesh == "2x2" and not any(empty):
            bad.append(f"{label}: no model shard was empty for any row")
    for row in oracle:
        drops = [rec["moe"][row["label"]]["moe_drop_frac"] for rec in recs]
        aux = [rec["moe"][row["label"]]["moe_aux_loss"] for rec in recs]
        row["rank_drop_frac"], row["rank_aux_loss"] = drops, aux
        emit({"phase": "scale", "check": "sharded MoE = single-process "
                                         "moe_apply over every expert",
              **row})
        if (not all(r["ok"] for r in row["ranks"])
                or any(d != row["moe_drop_frac"] for d in drops)
                or any(abs(a - row["moe_aux_loss"])
                       > 1e-6 * max(1.0, abs(row["moe_aux_loss"]))
                       for a in aux)):
            bad.append(f"{row['label']}: sharded != single-process {row}")
    timing = recs[0]["decode"]["timing"]
    for case in timing:
        emit({"phase": "scale", **case})
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=
                                               os.path.join(ROOT, "src")))
    summary = next((ln for ln in cli.stdout.splitlines()
                    if ln.startswith("[serve]")), None)
    emit({"phase": "scale", "check": "python -m repro_torch.launch.serve "
                                     "at its defaults on the card",
          "returncode": cli.returncode, "summary": summary,
          "seconds": time.perf_counter() - t0, "ranks_seconds": ranks_s,
          "stderr_tail": cli.stderr[-2000:] if cli.returncode else ""})
    if cli.returncode != 0 or not summary or " 16/16 requests" not in summary:
        bad.append(f"launch.serve: exit {cli.returncode}, {summary}")
    if bad:
        raise AssertionError("scale phase: " + "; ".join(bad))
    return {"scale": recs[0]["decode"]["launches"]}, timing


# ---------------------------------------------------------------------------
# phase 8: dryrun -- one rank's partitioned step on a fake process group
# ---------------------------------------------------------------------------
#: (arch, shape, 2x16x16?, expected status) of the dry-run phase; the
#: two costliest cells are left to the full sweep: kimi-k2-1t-a32b
#: train_4k on 2x16x16 (61.4 s alone on the card's host) and smollm-360m
#: train_4k on 16x16 (30.2 s, and the phase 64.9 s with it); the 1x1
#: train step runs the train path
DRYRUN_CELLS = (("smollm-360m", "prefill_32k", False, "ok"),
                ("smollm-360m", "decode_32k", False, "ok"),
                ("mixtral-8x7b", "decode_32k", True, "ok"),
                ("falcon-mamba-7b", "long_500k", False, "ok"),
                ("smollm-360m", "long_500k", False,
                 "skipped(DESIGN.md rule)"))
#: the phase's wall-seconds budget, from the tasks' submission at the
#: script's start to the last one's end (in the background, beside the
#: card's first phases)
DRYRUN_S = 60
#: worker processes of the host-only phases (planning, dryrun): the
#: card's host has 8 cores, and the parent drives the card meanwhile
HOST_WORKERS = 5
#: CommDebugMode's functional collectives -> the recorder's kinds
DRYRUN_KINDS = {"all_gather_into_tensor": "all-gather",
                "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def dryrun_worker(task):
    """One dry-run task in a spawned worker: ("cell", arch, shape,
    multi_pod) -> the record, with ``comm_debug`` (CommDebugMode's
    counts of the functional collectives by recorder kind); ("card", B,
    S) -> smollm-360m's train step at B, S on a 1x1 mesh."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    dryrun.fake_world()
    t0 = time.perf_counter()
    if task[0] == "card":
        _, b, s = task
        rec = dryrun.measure(get_config("smollm-360m"),
                             ShapeConfig("train_card", s, b, "train"),
                             make_host_mesh(dryrun.DEVICE))
        rec["seconds"] = time.perf_counter() - t0
        rec["t_end"] = time.time()
        return rec
    _, arch, shape, multi = task
    with CommDebugMode() as comm:
        rec = dryrun.dryrun_one(arch, shape, multi, verbose=False)
    counts = {}
    for op, n in comm.get_comm_counts().items():
        kind = DRYRUN_KINDS.get(getattr(op, "__name__", str(op)).split(
            ".")[-1], str(op))
        counts[kind] = counts.get(kind, 0) + n
    rec["comm_debug"] = counts
    rec["seconds"] = time.perf_counter() - t0
    rec["t_end"] = time.time()
    return rec


def planning_worker() -> tuple:
    """The planning phase in a spawned worker: (its lines, the traceback
    of its failure or None, the wall clock at its end).  The parent
    prints the lines."""
    import traceback
    lines = []
    globals()["emit"] = lines.append
    try:
        planning()
        err = None
    except Exception:  # noqa: BLE001 -- the parent raises it
        err = traceback.format_exc()
    return lines, err, time.time()


def start_host_work() -> dict:
    """Start the host-only phases in ``HOST_WORKERS`` spawned processes
    (no CUDA in them; the fake process group never meets the scale
    phase's gloo ranks): the planning phase, the dry-run's 1x1 train
    step (the longest task, first), then its cells.  The card's phases
    run meanwhile; :func:`planning_phase` and :func:`dryrun_phase` read
    the results.  The caller shuts the pool down."""
    import concurrent.futures as cf
    import multiprocessing
    pool = cf.ProcessPoolExecutor(
        HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    t0 = time.time()
    planning_f = pool.submit(planning_worker)
    card_f = pool.submit(dryrun_worker,
                         ("card", TRAIN["batch"], TRAIN["seq"]))
    cells = [pool.submit(dryrun_worker, ("cell", a, sh, m))
             for a, sh, m, _ in DRYRUN_CELLS]
    return {"pool": pool, "t0": t0, "planning": planning_f,
            "dryrun": cells + [card_f]}


def planning_phase(host) -> float:
    """Print the planning worker's lines; raise its failure.  Returns its
    wall seconds from the start of the host work."""
    lines, err, t_end = host["planning"].result()
    for line in lines:
        emit(line)
    if err:
        raise AssertionError(f"planning phase failed in its worker:\n{err}")
    return t_end - host["t0"]


def dryrun_phase(host) -> float:
    """The dry-run phase (see the module docstring, phase 8): the cells
    and the 1x1 train step, each a task of the host workers
    (:func:`start_host_work`).  Gates: each cell's status as
    ``DRYRUN_CELLS`` lists, flops > 0 where it ran, and every kind
    ``comm_debug`` saw counted as often by the recorder.  The 1x1 line
    is printed, not gated.  Returns the tasks' wall seconds, from their
    submission to the last one's end."""
    recs = [f.result() for f in host["dryrun"]]
    wall = max(r["t_end"] for r in recs) - host["t0"]
    bad = []
    for (arch, shape, multi, want), rec in zip(DRYRUN_CELLS, recs):
        row = {k: v for k, v in rec.items() if k != "traceback"}
        emit({"phase": "dryrun", **row})
        if rec["status"] != want:
            bad.append(f"{arch} {shape} {rec['mesh']}: {rec['status']} "
                       f"{rec.get('traceback', '')[-600:]}")
            continue
        if want != "ok":
            continue
        if not rec["flops"] > 0:
            bad.append(f"{arch} {shape}: flops {rec['flops']}")
        for kind, n in rec["comm_debug"].items():
            if rec.get(f"{kind}_count") != n:
                bad.append(f"{arch} {shape}: CommDebugMode saw {n} {kind}, "
                           f"the recorder {rec.get(f'{kind}_count')}")
    card = recs[-1]
    real = MEASURED.get("train_bf16", {})
    emit({"phase": "dryrun", "check": "smollm-360m's train step on a 1x1 "
                                      "mesh against the train phase's",
          "B": TRAIN["batch"], "S": TRAIN["seq"],
          "dryrun_peak_bytes": card["peak_bytes"],
          "dryrun_flops": card["flops"],
          "dryrun_seconds": card["seconds"],
          "train_max_memory_allocated": real.get("max_memory_allocated"),
          "train_flop_counter": real.get("flop_counter"),
          "peak_ratio": (card["peak_bytes"] / real["max_memory_allocated"]
                         if real.get("max_memory_allocated") else None),
          "flops_ratio": (card["flops"] / real["flop_counter"]
                          if real.get("flop_counter") else None)})
    if bad:
        raise AssertionError("dryrun phase: " + "; ".join(bad))
    return wall


#: the planning phase: (strategy, horizon) pairs both engines run (the
#: scalar proposal loop is slow, so it runs at 30 slots), and the seeds
#: of the study's grid on ``baseline`` at the default horizon
PLANNING_PAIRS = (("lbrr", 100), ("ga", 100), ("proposal", 30),
                  ("prop_avg", 30))
PLANNING_SEEDS = (0, 1, 2)


def planning() -> dict:
    """The paper's simulation study on the host (numpy only; the machine
    has no JAX, so the port is held against itself, as the reference's
    ``benchmarks/sim_bench.py`` holds its engines): the four strategies
    on ``baseline`` over ``PLANNING_SEEDS`` at the default horizon (100
    slots, drain 400) with ``n_workers=1`` (on-time share, completed
    share, total cost and wall seconds a trial, and the grid's summary by
    strategy); then the scalar engine must return the vectorised
    ``Simulator``'s trial dict for each of ``PLANNING_PAIRS`` (seed 0;
    at the default horizon the grid's own trial), with each engine's
    wall seconds."""
    from repro_torch.core.simulator_scalar import run_one_scalar
    from repro_torch.experiments.results import (metrics_equal,
                                                 summarize_rows)
    from repro_torch.experiments.runner import TrialSpec, run_grid, run_one
    strategies = ("proposal", "prop_avg", "lbrr", "ga")
    trials = []
    for seed in PLANNING_SEEDS:
        for strategy in strategies:
            t0 = time.perf_counter()
            row = run_grid([TrialSpec(seed=seed, strategy=strategy)],
                           n_workers=1)[0]
            trials.append(dict(row, wall_s=time.perf_counter() - t0))
    emit({"phase": "planning", "scenario": "baseline",
          "trials": [{k: r[k] for k in ("seed", "strategy", "on_time",
                                        "completed", "total_cost",
                                        "generated", "wall_s")}
                     for r in trials]})
    emit({"phase": "planning", "summary": summarize_rows(
        trials, keys=("strategy",)), "wall_s_by_strategy": {
        s: sum(r["wall_s"] for r in trials if r["strategy"] == s)
        / len(PLANNING_SEEDS) for s in strategies}})
    bad = [r for r in trials if not (r["generated"] > 0
                                     and 0 < r["on_time"] <= 1)]
    if bad:
        raise AssertionError(f"planning: empty or malformed trials {bad}")
    engines = []
    for strategy, horizon in PLANNING_PAIRS:
        spec = TrialSpec(seed=0, strategy=strategy, horizon_slots=horizon)
        t0 = time.perf_counter()
        vec = next((dict(r) for r in trials if r["seed"] == 0
                    and r["strategy"] == strategy
                    and r["horizon_slots"] == horizon), None)
        if vec is None:
            vec = run_one(spec)
        else:
            t0 -= vec.pop("wall_s")
        t1 = time.perf_counter()
        scalar = run_one_scalar(spec)
        t2 = time.perf_counter()
        engines.append({"strategy": strategy, "horizon_slots": horizon,
                        "equal": metrics_equal(vec, scalar),
                        "on_time": vec["on_time"],
                        "vectorised_s": t1 - t0, "scalar_s": t2 - t1})
    res = {"phase": "planning", "check": "vectorised Simulator = scalar "
                                          "engine, trial for trial",
           "runs": engines, "equal": all(e["equal"] for e in engines)}
    emit(res)
    if not res["equal"]:
        raise AssertionError(f"planning: the two engines disagree: "
                             f"{engines}")
    return res


#: the wgmma bodies' kernel entries the build must hold: the contiguous
#: and the cross form at hd 64 and 128, the chunk body at hd 64 and 128
#: for each of the paged chunk and the window form, and the quant
#: matmul's at n8 to n128 (int8, and each of int4's two group paths)
WGMMA_ENTRIES = {"flash_wgmma_kernel": 2, "cross_wgmma_kernel": 2,
                 "chunk_wgmma_kernel": 4, "quant_wgmma_kernel": 15}


def wgmma_ptxas(report: str) -> list:
    """ptxas's report (``-Xptxas=-v``) of each entry of the wgmma bodies
    (``WGMMA_ENTRIES``): its name, the registers a thread has at launch
    and the bytes it spills (stores and loads)."""
    found, entry = {}, None
    for ln in report.splitlines():
        if "Compiling entry" in ln:
            entry = (ln.split("'")[1] if any(
                k in ln for k in WGMMA_ENTRIES) else None)
        elif entry and "spill stores" in ln:
            _, stores, loads = (int(x) for x in
                                re.findall(r"(\d+) bytes", ln)[:3])
            found.setdefault(entry, {})["spill_bytes"] = stores + loads
        elif entry and "Used" in ln and "registers" in ln:
            found.setdefault(entry, {})["registers_at_launch"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return [{"entry": e, **v} for e, v in sorted(found.items())]


def device_tables(dev) -> dict:
    """The card against the constants the split rules read: its SM count
    against ``SM_COUNT`` (decode attention, quant matmul, rmsnorm,
    selective scan); the quant matmul's ``wgmma`` body at each rows of x
    it takes: its CTAs an SM, shared memory and stages against
    ``wgmma_ctas_per_sm``, ``wgmma_smem_bytes`` and ``wgmma_stages``, and
    its clusters of 1-8 CTAs against ``WGMMA_CLUSTERS``, the tables
    ``wgmma_splits`` reads; and ``cudaOccupancyMaxActiveClusters`` for clusters
    of 1-8 CTAs at the shared memory of the wide bodies (the paged
    prefill's, the ring form's, which takes the same tiles, and the
    decode's at gemma3-12b's G 2, through the empty kernel; and the
    ``wgmma`` bodies themselves at hd 64 and 128: the cross form's, whose
    clusters ``cross_splits`` sizes, and the paged chunk's and the window
    form's, whose clusters ``chunk_splits`` and ``ring_splits`` size)
    against ``WIDE_CLUSTERS``; the CTAs an SM holds of the contiguous flash
    form's ``wgmma`` body at hd 64, 112 and 128 (``WGMMA_HD``), the
    cross form's at hd 64 and 128 (``CROSS_WGMMA_HD``) and the paged
    chunk's and the window form's at hd 64, 112 and 128
    (``CHUNK_WGMMA_HD``, ``RING_WGMMA_HD``), from the occupancy calculator
    on each kernel at the dynamic shared memory it launches with, against
    ``WGMMA_CTAS_PER_SM``, and that shared memory and the keys of a K/V
    tile against their Python mirrors (``wgmma_smem_bytes``,
    ``wgmma_tile_keys``, which the split rules read).  Raises naming each
    table, size, expected and measured value that differ; it runs before
    any kernel phase."""
    import torch
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     quant_matmul, rmsnorm, selective_scan)
    from repro_torch.kernels.launch_floor import max_active_clusters
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = [f"{m.__name__}.SM_COUNT: expected {m.SM_COUNT}, got {sms}"
           for m in (decode_attention, quant_matmul, rmsnorm, selective_scan)
           if m.SM_COUNT != sms]
    clusters = {}
    for name, threads, smem in (
            ("paged_prefill_attention", 256,
             flash_attention.prefill_smem_bytes(256)),
            ("ring_chunk_attention", 256,
             flash_attention.prefill_smem_bytes(256)),
            ("paged_decode_attention", 128,
             decode_attention.decode_smem_bytes(256, 2)),
            ("paged_cross_attention hd 64", 384,
             flash_attention.wgmma_smem_bytes(64, "cross")),
            ("paged_cross_attention hd 128", 384,
             flash_attention.wgmma_smem_bytes(128, "cross")),
            *((f"{kernel} wgmma hd {hd}", 384,
               flash_attention.wgmma_smem_bytes(hd, form))
              for kernel, form in (("paged_prefill_attention", "chunk"),
                                   ("ring_chunk_attention", "ring"))
              for hd in (64, 128))):
        # the wgmma bodies' own (their registers hold them to a CTA an
        # SM); the others' through the empty kernel at their shared memory
        hd = int(name.split()[-1]) if "hd" in name else None
        got = {sp: (flash_attention.cross_wgmma_clusters(hd, sp)
                    if name.startswith("paged_cross") else
                    flash_attention.chunk_wgmma_clusters(
                        hd, sp, "ring" if name.startswith("ring") else
                        "chunk") if "wgmma" in name else
                    max_active_clusters(sp, threads, smem))
               for sp in range(1, 9)}
        clusters[name] = {"threads": threads, "smem": smem, "clusters": got}
        bad += [f"WIDE_CLUSTERS[{sp}] at {name}'s {smem} B: expected "
                f"{decode_attention.WIDE_CLUSTERS[sp]}, got {n}"
                for sp, n in got.items()
                if n != decode_attention.WIDE_CLUSTERS[sp]]
    occupancy = {}
    for form, hds in (("flash", flash_attention.WGMMA_HD),
                      ("cross", flash_attention.CROSS_WGMMA_HD),
                      ("chunk", flash_attention.CHUNK_WGMMA_HD),
                      ("ring", flash_attention.RING_WGMMA_HD)):
        for hd in hds:
            ctas, smem, keys = flash_attention.wgmma_occupancy(hd, form)
            occupancy[f"{form} hd {hd}"] = {"smem": smem, "ctas": ctas,
                                            "tile_keys": keys}
            if ctas != flash_attention.WGMMA_CTAS_PER_SM:
                bad.append(f"WGMMA_CTAS_PER_SM at the wgmma body's {smem} "
                           f"B: expected "
                           f"{flash_attention.WGMMA_CTAS_PER_SM}, got {ctas} "
                           f"({form} form, hd {hd})")
            # the Python mirrors the split rule and the tests read
            for mirror, got in (("wgmma_smem_bytes", smem),
                                ("wgmma_tile_keys", keys)):
                want = getattr(flash_attention, mirror)(hd, form)
                if want != got:
                    bad.append(f"{mirror}({hd}, {form!r}): expected "
                               f"{want}, the kernel has {got}")
    # the quant matmul's wgmma body at every rows of x a CTA it takes:
    # CTAs an SM, shared memory and stages against the mirrors
    # wgmma_splits reads, and its clusters against WGMMA_CLUSTERS
    quant = {}
    for fmt in ("int8", "int4"):
        for rows in (8, 16, 32, 64, 128):
            ctas, smem, stages = quant_matmul.wgmma_occupancy(fmt, rows)
            got = {sp: quant_matmul.wgmma_clusters(fmt, rows, sp)
                   for sp in range(1, 9)}
            quant[f"{fmt} rows {rows}"] = {"ctas": ctas, "smem": smem,
                                           "stages": stages,
                                           "clusters": got}
            want_ctas = quant_matmul.wgmma_ctas_per_sm(rows)
            for mirror, want, have in (
                    ("wgmma_ctas_per_sm", want_ctas, ctas),
                    ("wgmma_smem_bytes", quant_matmul.wgmma_smem_bytes(
                        fmt, rows), smem),
                    ("wgmma_stages", quant_matmul.wgmma_stages(fmt, rows),
                     stages)):
                if want != have:
                    bad.append(f"quant_matmul.{mirror}({fmt!r}, {rows}): "
                               f"expected {want}, the kernel has {have}")
            table = quant_matmul.WGMMA_CLUSTERS.get(want_ctas, {})
            bad += [f"quant_matmul.WGMMA_CLUSTERS[{want_ctas}][{sp}] at "
                    f"{fmt} rows {rows}: expected {table.get(sp)}, got {n}"
                    for sp, n in got.items() if n != table.get(sp)]
    res = {"phase": "device", "check": "SM_COUNT, WIDE_CLUSTERS, "
                                       "WGMMA_CTAS_PER_SM, the wgmma "
                                       "mirrors and the quant matmul's "
                                       "wgmma mirrors against this card",
           "sm_count": sms, "max_active_clusters": clusters,
           "wgmma_ctas_per_sm": occupancy, "quant_wgmma": quant,
           "mismatches": bad}
    emit(res)
    if bad:
        raise AssertionError("the split rules' card tables do not match "
                             "this card: " + "; ".join(bad))
    return res


def kernel_line(cases, launches_by_run) -> dict:
    """One entry per kernel, at its main-path shape in its main dtype
    (``MAIN_DTYPE``, else bfloat16: decode rows for the quant matmuls and
    for rmsnorm, on its add_norm body, smollm-360m's hd 64 for the paged
    and dense decode, pos 256 for prefill, the wrapped ring (pos 3000) for
    the ring form, the decode step for the scan), with the launches of the
    serve run that drives it (``LAUNCH_RUN``); every case in ``cases``,
    gemma3-12b's hd 256 rows among them."""
    def self_attn_hd64(c):
        return c["shape"]["hd"] == 64 and "cross" not in c["shape"]
    main = {"rmsnorm": lambda c: (c["shape"] == [8, 960]
                                  and c["body"] == "add_norm"),
            "paged_decode_attention": self_attn_hd64,
            "paged_prefill_attention": lambda c: c["shape"]["pos"] == 256,
            "paged_chunk_attention": lambda c: True,
            "paged_cross_attention": lambda c: (c["shape"]["hd"] == 128
                                                and c["shape"]["B"] == 1),
            "ring_chunk_attention": lambda c: c["shape"]["pos"] == 3000,
            "dense_decode_attention": self_attn_hd64,
            "quant_matmul_int8": lambda c: c["shape"] == [8, 960, 2560],
            "quant_matmul_int4": lambda c: c["shape"] == [8, 960, 2560],
            "selective_scan": lambda c: c["shape"]["T"] == 1,
            "flash_attention": lambda c: c["shape"]["label"] == "train",
            "selective_scan_backward": lambda c: (c["shape"]["model"]
                                                  == "falcon-mamba-7b"),
            "dense_decode_attention_partial": lambda c: (
                c["shape"]["model"] == "smollm-360m")}
    out = []
    for name in REPLACES:
        mine = [c for c in cases if c["kernel"] == name]
        c = next(c for c in mine
                 if c["dtype"] == MAIN_DTYPE.get(name, "bfloat16")
                 and main[name](c))
        out.append({"name": name, "route": "cuda",
                    "source": BODY_SOURCES.get((name, c.get("body")),
                                               SOURCES[name]),
                    "replaces": REPLACES[name],
                    "launches": launches_by_run[LAUNCH_RUN[name]][name],
                    "launch_run": LAUNCH_RUN[name],
                    "launches_by_run": {run: n[name] for run, n
                                        in launches_by_run.items()},
                    "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                    "prev_ms": c["prev_ms"],
                    "call_ms": c["call_ms"], "plain_ms": c["plain_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                    "library_ms": c["library_ms"],
                    **{k: c[k] for k in ("body", "library_pair_ms",
                                         "bytes_bound_ms", "flops_bound_ms")
                       if k in c},
                    "dtype": c["dtype"], "shape": c["shape"],
                    "cases": [{k: x[k] for k in ("dtype", "shape", "body",
                                                 "ms", "prev_ms",
                                                 "call_ms", "plain_ms",
                                                 "library_ms",
                                                 "library_pair_ms",
                                                 "library_weight_only_ms",
                                                 "library_note", "cold_ms",
                                                 "bound_ms", "bound_by",
                                                 "bytes_bound_ms",
                                                 "flops_bound_ms",
                                                 "max_abs_err", "max_rel_err")
                               if k in x}
                              for x in mine]})
    return {"kernels": out}


def main() -> int:
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    full_report = _build.ptxas_report()
    report = [ln.strip() for ln in full_report.splitlines()
              if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "key": _build.build_key(),
          "ptxas": report})
    wgmma = wgmma_ptxas(full_report)
    emit({"phase": "build", "kernel": "flash_attention, "
                                       "paged_cross_attention, the chunk "
                                       "forms and the quant matmul, wgmma "
                                       "bodies",
          "ptxas": wgmma})
    counts = {k: sum(k in e["entry"] for e in wgmma) for k in WGMMA_ENTRIES}
    if counts != WGMMA_ENTRIES or any(e.get("spill_bytes", 1)
                                      for e in wgmma):
        raise AssertionError(f"a wgmma body is missing from the build or "
                             f"spills: {counts} entries of "
                             f"{WGMMA_ENTRIES}; {wgmma}")

    seconds = {}

    def timed(name, fn):
        """Run phase ``name`` and end it with a line of its wall seconds."""
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        emit({"phase": name, "seconds": seconds[name]})
        return out

    host = start_host_work()
    try:
        timed("device", lambda: device_tables(dev))
        cases = timed("kernels", lambda: kernel_cases(dev))
        # the host-only phases ran beside the kernels phase: each line
        # of seconds is the parent's wait, ``*_background`` the phase's
        # wall time in its workers
        seconds["planning_background"] = timed(
            "planning", lambda: planning_phase(host))
        timed("parity", lambda: parity(dev))
        launches = timed("serve", lambda: serve(dev))
        launches.update(timed("train", lambda: train(dev)))
        scale_launches, scale_cases = timed("scale", lambda: scale(dev))
        launches.update(scale_launches)
        cases = cases + scale_cases
        seconds["dryrun_background"] = timed(
            "dryrun", lambda: dryrun_phase(host))
    finally:
        host["pool"].shutdown(cancel_futures=True)
    if seconds["dryrun_background"] > DRYRUN_S:
        raise AssertionError(f"dryrun phase: "
                             f"{seconds['dryrun_background']:.1f} s, over "
                             f"its {DRYRUN_S} s")
    emit({"phase": "timing", "seconds": seconds,
          "total": time.perf_counter() - t_start})
    emit(kernel_line(cases, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
