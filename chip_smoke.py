#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (src/repro_torch/) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device  -- the card's name and power limit (nvidia-smi); no CUDA, no run
  2. build   -- nvcc builds every kernel from csrc/ into build/kernels/, one
                process per source, all at once
  3. parity  -- each kernel against its plain PyTorch version on the card, at
                the main paths' shapes, with the stated tolerance; each case
                timed with CUDA events (kernel, plain version, one PyTorch
                library call as a yardstick) beside its roofline bound:
                K1 (bf16, and f32 at the MLP shapes; on the GEMM core's
                packed walk, under every candidate plan, with the merge
                of each split pick, f32 against a float64 product) and K9 (danube's,
                mistral-large's and qwen2-moe's attention shapes; with
                K9 and K12 the achieved TFLOP/s, the share of the bound,
                the CTAs resident per SM and K12's n_split)
  4. serve   -- serve h2o-danube-1.8b at full width and depth
                (block_sparse, block 128, flash_tight, ERK sparsity 0.8,
                seed 0): 8 staggered greedy requests x 32 tokens through
                ServeEngine; every request DONE, no quarantine, each kernel
                launched, and the kernel path's prefill and first decode
                logits within tolerance of the plain dense path on the same
                weights; then the decode step's device time (CUDA graph),
                the device time of its 168 K1 launches (and their planned
                split merges) on the served packs, and K1 parity and
                timings on layer 0's ERK packs, under every candidate plan
  5. train   -- train h2o-danube-1.8b at full width and depth with RigL
                (block_sparse, flash_tight, ERK 0.8 in 128x128 blocks, Adam,
                warmup-cosine, batch 8 x 1024 in the config's 4 microbatches,
                6 steps, a drop/grow at step 2): first K2, K3 (on layer 0's
                packs and supersets) and K10, K11 against their plain
                versions and timed (TFLOP/s, share of the bound, SDPA's
                backward masked and, where purely causal, is_causal; each
                launch's plan, CTAs, occupancy, registers, shared and spill
                bytes, longest walk; every candidate plan timed; K2 and K3
                on the GEMM core under every candidate plan on the pack's
                live blocks, their f32 cases against a float64 product, and
                the merge of each split pick, bit for bit); the step-0
                loss and two weight gradients
                against the plain dense path on the same weights; then
                ``train_loop``: finite losses, the exact launch counts of
                every kernel per step (336 K1, 168 K2 and 168 K3 a
                microbatch and the split merges each pack entry's plans
                make), and after the update unchanged block
                counts, a valid, fresh pack and B ⊇ A; wall and device time
                per step, tokens per second, peak memory, the profiled
                step's busy time and the block-sparse kernels' share of it
  6. masked serve -- serve the same model under kernel='masked' (ERK 0.8
                elementwise masks, flash_tight): the same 8 requests, every
                request DONE, logits against the plain dense path, exactly
                168 K13 launches and the planned split merges per decode
                step, the decode step's device time; then K13 (4 -> 16 and
                2048 rows), K14, K15 and K19 (sr off and on) against their
                plain versions on layer 0's served weights and masks, timed
                beside their bounds; K13, K14 and K15 also under every
                candidate plan (each within its bound; whether ``fwd_plan``'s
                pick was the fastest, the pick's launch, TFLOP/s, TB/s, share
                of the bound), their f32 cases at 2048 rows against a
                float64 product (at most 8x the plain version's RMS error),
                and the split merge at each split pick, bit for bit
  7. masked train -- RigL with elementwise masks and the Top-KAST superset
                (Adam, batch 2 x 1024 in one microbatch, 6 steps, a
                drop/grow at step 2): the step-0 loss and gradients against
                the plain dense path, exact launches per step (336 K13, 168
                K14 and 168 K15, each with their planned split merges), and
                after the update counts kept, B ⊇ A and the carrier fresh
  8. fused train -- the fused SGD epilogue (momentum 0.9, bf16 state with
                stochastic rounding), 2 steps: 168 K19, 168 K14 and their
                planned split merges and no K15 launch or dw merge per
                step, bf16
                momentum within the reference's bound of the unfused step's
  8b. fused block-sparse train -- K7 against its plain version on layer 0's
                ERK packs and Top-KAST supersets (mlp.wi, mlp.wo f32,
                attn.wq bf16; 2048 and 16 rows, sr off and on, mom bf16 and
                f32), timed beside the unfused work it replaces (K3 and the
                SGD update), each case under every candidate plan (sr on
                bit for bit sr_to_bf16 of the same plan's f32 m_new), the
                f32 cases against a float64 epilogue, the fused merge of a
                split pick bit for bit; then the same model under
                block_sparse (128x128
                blocks, flash_tight, ERK 0.8, RigL with the superset) with
                the fused SGD epilogue, 2 x 1024 tokens in one microbatch, 2
                steps each beside an unfused step: exactly 336 K1 and 168
                K2 (and their planned merges), 168 K7 (and their planned
                fused merges), no K3 and 48/24/24
                K9-K11 per fused step, the bf16
                momentum within the reference's bound of the unfused one's
  9. paged serve -- K12 (the paged-prefix flash kernel) against its plain
                version at mistral-large's widths (Sq 16 and 128, ctx 0 to
                4096 over 256 pages of 16, a softcap case), timed; then serve
                mistral-large-123b at its published widths, 4 of 88 layers
                (block_sparse, flash_tight, ERK 0.8, seed 0) through the
                paged engine with the prefix cache: 8 requests on one
                512-token template, 2 of them sampled (temperature 0.8, top-k
                40): every request DONE, 1 prefix miss and 7 hits, clean pool
                books, exactly 28 K12 launches; a suffix prefill's logits
                against the full prefill's; paged and contiguous engines'
                greedy streams identical; K1 on layer 0's served packs
                under every candidate plan; the decode step's device time
                and K1's share of it
 10. moe serve -- serve qwen2-moe-a2.7b at its published widths, 12 of 24
                layers (block_sparse, 128x128 blocks, flash_tight, ERK 0.8,
                seed 0): the 8 requests of phase 4 through the engine (exact
                length prefills); every request DONE, exactly 36 K4 (the 60
                experts' banks wi/wg/wo) and 84 K1 launches per prefill and
                decode step, and the K1/K4 split merges a decode step's
                plans make; active logits bit-identical under changed dead
                slots; the share of routing decisions that agree with the
                plain dense path (at least 95%), the logits of the prompts
                whose routing agreed everywhere, and of every prompt with
                the dense path's routing pinned to the kernel path's; the decode step's device time and K4's
                share; then K4 against its plain version (layer 0's ERK
                packs, a uniform and a dead-expert topology; 4 and 84 rows;
                f32 and bf16), timed, under every candidate plan, f32
                against a float64 product
 11. moe masked serve -- the same model under kernel='masked': 4 requests
                (prompts 100/300, 16 tokens), exactly 36 K16 and 84 K13
                launches per step and the planned split merges of a decode
                step, the same checks; then K16 against its plain version
                on layer 0's elementwise masks, timed, and under every
                candidate plan
 12. moe train -- K10/K11 at qwen2-moe's attention (G = 1, head_dim 128,
                S = 1024) against their plain versions, timed; then train
                qwen2-moe-a2.7b at its published widths, 3 of 24 layers
                (block_sparse, 128x128 blocks, flash_tight, ERK 0.8, RigL
                with the Top-KAST superset, Adam, warmup-cosine, seed 0;
                batch 8 x 1024 in the config's 4 microbatches, 6 steps, a
                drop/grow at step 2): first K5 and K6 against their plain
                versions (layer 0's ERK packs and supersets, a uniform and a
                dead-expert topology; 171 and 16 rows; f32 and bf16), timed,
                each under every candidate plan of the GEMM core, their f32
                cases against a float64 product;
                the step-0 loss and the gradients of a bank, the shared MLP
                and the router against the plain dense path with routing
                pinned; then ``train_loop``: finite losses, the exact
                launches of every kernel in every step (K4 72, K5 and K6 36
                per train step, K1 168, K2 and K3 84, with the planned
                split merges of K1-K6), after the update counts kept,
                B ⊇ A and the
                pack fresh; wall and device time per step, tokens per
                second, the peak memory of the steady and the update step,
                the busy share of the profiled step and K4-K6's share of it
 13. moe masked train -- the same model under kernel='masked' (batch 2 x
                1024 in one microbatch, 6 steps, a drop/grow at step 2): K17
                and K18 on layer 0's elementwise masks and supersets, timed,
                each under every candidate plan, K18's f32 cases against a
                float64 product; the same checks, with K13-K18's exact
                launches and the planned split merges of each
 14. moe fused train -- qwen2-moe-a2.7b (3 of 24 layers) with the fused SGD
                epilogue, 2 x 1024 tokens in one microbatch (C = 171), under
                block_sparse: K8 against its plain version (layer 0's ERK
                banks and supersets, a uniform topology, two groups with no
                block; 171 and 16 rows; f32 and bf16; sr off and on; each
                under every candidate plan) and against K20 bit for bit on
                a block-aligned mask (the same tile and split), K7 on layer
                0's attn.wq (bf16) and dense shared MLP (f32) at 2048 rows,
                sr off and on, then 2 fused steps beside unfused ones with
                routing pinned: exactly 42 K1, 21 K2, 21 K7, 18 K4, 9 K5, 9
                K8 (and K1's, K4's, K2's, K5's, K7's and K8's planned
                merges), no K3 or K6 and
                6/3/3 K9-K11 per fused step; under
                masked: K20 on layer 0's supersets and K19 on the same 2-D
                projections, then 42 K13, 21 K14, 21 K19, 18 K16, 9 K17, 9
                K20, the planned dx split merges, no K15 or K18 and no dw
                merge; the
                momentum bound leaf by leaf, wall times, peak memory
 15. topk    -- K21 (the 512-bin |x| histogram) against its plain version
                in every bin: danube's layers/0/mlp/wi/w (2560 x 6912) from
                its seeded init, dense, masked at its ERK density and in
                bf16, and a seeded f32 matrix of mistral-large's MLP shape
                (12288 x 28672, 352 M elements), dense and masked; then
                ``ops.topk_threshold`` at k = 20% and 1% of n through K21
                (2 launches) bit for bit against the plain path, K21 on the
                refinement's skewed input, the count kept against k, the
                bracketing bin's occupancy and the gap to ``torch.kthvalue``;
                K21 timed beside its byte bound, the plain version and
                ``torch.histc``, the threshold beside ``torch.kthvalue``
 16. methods train -- the paper's baselines through ``train_loop`` on
                h2o-danube-1.8b at full width and depth, 2 x 1024 tokens in
                one microbatch, 4 steps, Adam: set, snfs and topkast under
                block_sparse (128x128, flash_tight, ERK 0.8, a drop/grow at
                step 2; exactly 336 K1, 168 K2, 168 K3 and their planned
                merges, 48/24/24 K9-K11 per
                step, set's update step K9-K11 alone (no superset: the
                dense gradient); after the update block counts kept, grown
                = dropped, the pack fresh, B ⊇ A, snfs's dense momentum
                zero outside B, topkast's weights exactly 0 outside B), then
                pruning and snip under masked (336 K13, 168 K14 and 168 K15
                with their planned split merges per step; pruning's masks
                monotone and at the schedule's target density after its
                prune, snip's per-layer density the ERK map's); wall s per
                step, tok/s, peak GiB, the update step's s
 17. resume  -- h2o-danube-1.8b at full width, 4 of 24 layers, with the train
                phase's settings (block_sparse 128x128, flash_tight, ERK
                0.8, RigL with the Top-KAST superset, Adam, warmup-cosine,
                8 x 1024 tokens in 4 microbatches, delta_t 2, 6 steps,
                updates after steps 2 and 4): ``run_with_restarts`` with a
                preemption at step 3 (``ckpt_every=0``: the forced saves at
                the preemption and at the end) against an uninterrupted
                ``train_loop`` from the same seed: every leaf of params,
                masks, supersets, Adam state, pack and the non-finite
                counter bit for bit equal, the losses of steps 4-6 equal,
                the pack valid and fresh after the restore; the checkpoint's
                bytes on disk (reckoned from the state beforehand), the
                masks' packed bytes against their bool bytes, the snapshot,
                background write, wait and restore seconds, the step times
                before and after the restart; the workdirs deleted
 18. chaos + obs serve -- the serve phase's model and requests with
                ``obs=Observability()``, ``max_retries=1`` and a
                ``FaultInjector(0)`` that poisons two active decode rows
                (NaN at step 2, inf at step 5) and every prefill of rid 6:
                rid 6 FAILED after its retry, the other 7 DONE with the
                serve phase's tokens (the retried ones included); the
                trace's quarantine instants equal ``quarantine_log``, each
                joined to a fired injection; the metrics text
                (chiprun_out/chaos_metrics.prom) parses to 7 DONE and 1
                FAILED, the trace (chiprun_out/chaos_trace.json) loads as
                Chrome JSON; the same run with ``obs=None`` and no faults
                gives the same tokens; the host decode step with obs on and
                off
 19. lockstep -- ``serve_session`` on the same model (batch 4, prompt 48,
                gen 32, the CLI defaults): finite tokens, exactly 168 K1
                and 24 K9 in the prefill and 168 K1 and no K9 in each decode
                step, the prefill's last logits within the serve phase's
                tolerance of the plain dense path; prefill s, decode s per
                token and tok/s beside the engine's
 20. gru     -- the paper's §4.2 char LM (embed 128, GRU 512, readouts
                256/128, vocab 256) on the card: the repo's byte corpus
                (batch 8, seq 96), uniform 75% masks, RigL with Adam, 30
                steps with drop/grow at steps 10 and 20: step ms, the loss
                falling, nnz kept across the updates; one planted-teacher
                batch (shapes, determinism, noise).  No kernel: plain
                matmuls, as the reference
 21. xlstm serve -- xlstm-1.3b at full width and depth (48 layers, 1.136 B
                parameters, tied embeddings, ERK 0.8, seed 0) through the
                engine, block_sparse (128x128: the 8 requests of phase 4)
                and masked (4 requests): every request DONE; exactly 222 K1
                (K13) a prefill and a decode step, 6 K4 (K16) a decode step
                and 6 a prompt token, with the planned split merges; an
                inactive slot frozen bit for bit; the greedy tokens' agreement
                with the plain dense path (4 requests) and two prompts'
                prefill logits within 2e-3;
                prefill ms, the decode step's host and device (CUDA graph) ms
 22. xlstm train -- 8 of 48 layers at full width (7 mLSTM + 1 sLSTM, 275 M
                parameters), RigL with the superset, Adam, 2 x 1024 tokens, 4
                steps, a drop/grow at step 2, in both modes: first K4-K6
                (K16-K18) at sLSTM's recurrent bank's shapes (G 4, K 512, N
                2048; C = 1, 8, 16; f32) against their plain versions, timed
                beside their bound and torch.bmm; the step-0 loss and the
                gradients of wq, w_in, r and the tied table against the
                plain dense path; then the exact launches of K1-K6 (K13-K18)
                and their merges in every step, counts kept, B ⊇ A and the
                pack fresh; step s, tok/s, peak GiB, the busy share
 23. hymba flash -- K9, K10 and K11 at hymba's attention (25 heads over 5,
                G = 5, head_dim 64, bf16, S = 2048, window 1024 and global)
                on their exact d = 64 instantiations against their plain
                versions, timed beside the generic instantiation (also held
                to the bound), scaled_dot_product_attention (forward,
                backward) and the bound; both instantiations' launches
 24. hymba serve -- hymba-1.5b at full width and depth (32 layers, 1.92 B
                parameters, attention and the selective SSM in every block,
                global layers 0/15/31, window 1024 elsewhere, tied; ERK 0.8,
                seed 0) through the paged engine (a local ring pool and a
                global pool of 16-token pages beside the slot-batched SSM
                states), block_sparse (64x64 blocks: 8 requests, prompts
                200/700/1500, 32 tokens) and masked (4 requests, prompts
                200/1500, 16 tokens): every request DONE, clean pool books;
                exactly 288 K1 (K13) a prefill and a decode step and the
                planned split merges, 32 K9 a prompt, a profiled prefill on
                the exact d = 64 K9 alone; an inactive slot's SSM state
                bit for bit; the greedy tokens' agreement with the plain
                dense path and two prompts' prefill logits within 5e-3;
                prefill ms, the decode step's host and device (CUDA graph) ms
 25. hymba train -- 4 of 32 layers at full width (layer 0 global, 1-3
                local; 285 M parameters), RigL with the superset, Adam, 1 x
                2048 tokens, 4 steps, a drop/grow at step 2, in both modes:
                the step-0 loss and the gradients of in_proj, out_proj, wq,
                the dense w_dt, a_log and the tied table against the plain
                dense path; the exact launches of K1-K3 (K13-K15), K9-K11
                and their merges in every step, the profiled step on the
                exact d = 64 flash kernels alone, counts kept, B ⊇ A and the
                pack fresh; step s, tok/s, peak GiB, the busy share
 26. flash d = 256 -- K9, K10 and K11 at gemma3-4b's attention (8 heads
                over 4, G = 2, head_dim 256, bf16, S = 2048, window 1024
                and global) on their exact d = 256 instantiations against
                their plain versions, timed beside
                scaled_dot_product_attention (forward, backward) and the
                bound; each launch's CTAs an SM, registers, shared and
                spill bytes (no spill)
 27. gemma3 serve -- gemma3-4b at full width and depth (34 layers, ~3.9 B
                parameters: qk-norm, sandwich norms, GeGLU, 5 local
                (window 1024) to 1 global, tied; ERK 0.8, seed 0) through
                the paged engine (a local ring pool and a global pool),
                block_sparse (128x128) and masked on one init's weights: 3
                requests (prompts 300/1400, 16 tokens; 1400 wraps the
                rings), every request DONE, clean pool books; exactly 238
                K1 (K13) a prefill and a decode step and the planned
                merges, 34 K9 a prompt, a profiled prefill on the exact
                d = 256 K9 alone; every greedy token equal to the plain
                dense path's; prefill ms, the decode step's host and device
                ms
 28. gemma3 train -- 6 of 34 layers at full width (one 5:1 period), RigL
                with the superset, Adam, 1 x 2048 tokens, 4 steps, a
                drop/grow at step 2, in both modes: the step-0 loss and the
                gradients of wi, wq, a qk-norm and a post-norm scale and the
                tied table against the plain dense path; the exact launches
                of K1-K3 (K13-K15), K9-K11 and their merges in every step,
                the profiled step on the d = 256 flash kernels alone
 29. command-r serve -- command-r-plus-104b at full width, 4 of 64
                layers (parallel blocks, the tied 256000-row table),
                block_sparse, as phase 11 serves mistral-large: the prefix
                cache (K12 at d = 128) and 2 sampled requests, exact K12
                counts, suffix against full prefill logits, paged against
                contiguous streams, and the greedy streams equal to the
                plain dense path's; K1 on layer 0's served packs
 30. command-r train -- 1 of 64 layers at full width, block_sparse, SGD
                with momentum (bf16 state), 1 x 512 tokens, 3 steps: the
                step-0 loss and gradients of wi, wq and ln1 against the
                plain dense path; the exact launches a step, the profiled
                step on the d = 128 flash kernels alone; peak GiB
 31. flash frontends -- K9, K10 and K11 at hubert-xlarge's bidirectional
                attention (16 heads, G = 1, head_dim 80, causal=0: S = 4096
                and S = 1000 padded to 1024, the padded case also through
                the wrapper, whose trim must give the padded query rows
                zero dO) with K10 and K11 under every candidate plan, and
                at internvl2-1b's causal attention (14 heads over 2, G = 7,
                head_dim 64, S = 2048), against their plain versions,
                timed beside the generic instantiation, SDPA and the bound
 32. hubert encode -- hubert-xlarge at full width and depth (48 layers,
                the frames frontend, plain GELU, bidirectional attention;
                ERK 0.8, seed 0): ``lm_forward`` and the head on 1 x 4096
                seeded frames, block_sparse (128x128) and masked on one
                init: exactly 288 K1 (K13), their planned merges and 48 K9
                a forward; logits within 5e-2 of the largest and the
                frames' argmax labels agreeing at least 90% with the plain
                dense path; the engine, serve_session and lm_prefill refuse
                the encoder; encode wall and device ms
 33. hubert train -- 8 of 48 layers at full width, 1 x 4096 frames, 4
                steps with a drop/grow at step 2, both modes: the step-0
                loss and the gradients of wi, wq, frontend_proj and head
                against the plain dense path; exact launches a step (2 x 48
                K1, 48 K2, 48 K3, 16 K9, 8 K10, 8 K11 and the planned
                merges), the profiled step on the d = 80 flash kernels alone
 34. internvl serve -- internvl2-1b at full width and depth (24 layers,
                G = 7 at head_dim 64, d_model 896, the tied table) through
                the engine, contiguous and paged, block_sparse and masked:
                8 requests, each 256 seeded patch rows before a text prompt
                of 100/600/1200 tokens, 16 tokens each; every request DONE,
                clean pool books; exactly 168 K1 (K13) a prefill and a
                decode step and the planned merges, 24 K9 a prompt, the
                profiled prefill on the exact d = 64 K9 alone; every greedy
                token equal to the plain dense path's; K1 on layer 0's
                served packs (7 K-blocks) under every candidate plan at 16
                and 2048 rows
 35. internvl train -- full width and depth (24 layers), 1 x 2048 rows
                (256 patches + 1792 text tokens), 4 steps with a drop/grow
                at step 2, both modes: the step-0 loss and the gradients of
                wi, wq, frontend_proj and the tied table against the plain
                dense path; exact launches a step (2 x 168 K1, 168 K2, 168
                K3, 48 K9, 24 K10, 24 K11 and the planned merges), the
                profiled step on the d = 64 flash kernels alone
 36. grok flash -- K9, K10 and K11 at grok-1-314b's attention (48 heads
                over 8, G = 6, head_dim 128, softcap 30, causal, S = 1024
                and 2048) against their plain versions, timed beside the
                generic instantiation, SDPA (no softcap) and the bound
 37. grok banks -- K4, K5, K6 and K16, K17, K18 once each on a whole grok
                expert bank (8 x 6144 x 32768 = 1.61 G elements, f32 as the
                path upcasts it; the index widths) against their plain
                versions, timed beside torch.bmm and the bound
 38. grok serve -- grok-1-314b at full width, 4 of 64 layers, bf16 masters,
                block-aligned ERK 0.8 masks, paged, block_sparse and
                masked: 8 requests (prompts 100/400/1000, 32 tokens), every
                request DONE, clean pool books; exactly 16 K1 (K13) and 12
                K4 (K16) a prefill and a decode step and the planned
                merges, 4 K9 a prompt; the prefix cache refused; greedy
                tokens and routing against the plain dense path; K1 and K4
                without a pack entry equal to the calls with one; the
                decode step's profiled busy ms and its bank casts' ms
 39. grok train -- 1 of 64 layers at full width, 16 x 1024 tokens in 16
                microbatches accumulated in bf16, SGD with a bf16
                momentum, 3 steps, both modes: the step-0 loss and the
                gradients of wi, wo, the router, wq and the head against
                the plain dense path; exact launches a step (16 x (8 K1, 4
                K2, 4 K3, 6 K4, 3 K5, 3 K6, 2 K9, K10, K11) and the planned
                merges); every leaf bf16 after the steps; block_sparse
                then one drop/grow on 1 x 1024 tokens and a fresh pack
 40. remat dots -- remat_policy='dots' against 'none' on h2o-danube-1.8b at
                full width, 4 of 24 layers, 2 x 1024 tokens, one forward
                and backward each: block_sparse with flash_tight, the same
                launches under both (2 x 28 K1, 28 K2, 28 K3, 8 K9, 4 K10,
                4 K11: the kernels opaque to the policy) and gradients
                equal bit for bit; kernel='dense' with flash_tight and with
                dense attention, gradients equal bit for bit and the
                backward's mm/bmm/addmm/baddbmm as many as without remat
                (no product recomputed; 'none' recomputes them); seconds
                and peak GiB of each
 41. data parallel -- the same danube, 4 of 24 layers, block_sparse, RigL
                with the superset, Adam: ``train_loop`` in one process (8
                x 1024 in 4 microbatches, 4 steps, a drop/grow at step 2),
                then two spawned ranks (gloo over 127.0.0.1,
                ``make_local_mesh(2, 1)`` on the one card, 4 x 1024 rows
                each in 2 microbatches) through the same steps: losses
                within rel 2e-3 of the one process's, masks, supersets and
                packs identical across the ranks, each rank's K1-K3 and
                K9-K11 a train step half the one process's; step, all-reduce
                seconds and peak GiB a rank; then one rank under NCCL
                through the same train step, every leaf bit for bit the
                plain step's
 42. report  -- one JSON line of per-kernel numbers (all twenty-one kernels,
                K13/K16's split merge and, where a timed K14/K17, K15/K18,
                K3/K6, K1/K4 or K2/K5 case splits, theirs), the card line,
                and last
                {"ok": true,
                "device": {...}}

Per-case details also go to chiprun_out/chip_smoke.json.  Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12  # f32 outside the tensor cores (the f32 kernels' FFMA)
L2_BYTES = 50 * 2**20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_BF16_FLOP_S):
    """(least time in ms, "bytes" or "operations"): bytes over the memory
    rate against operations over ``peak`` (the operands' type's rate)."""
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def peak_of(torch, dtype) -> float:
    return PEAK_F32_FLOP_S if dtype == torch.float32 else PEAK_BF16_FLOP_S


class Timer:
    """Device time of one call by CUDA events, L2 flushed before each
    repetition (the main path reads every layer's weights cold).  A spin
    kernel ahead of the first event keeps the card busy while the host
    enqueues the call, so the events measure the call's device work and not
    the host's launch overhead."""

    SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / reps


def k1_case(torch, timer, bsm, label, x, w, idx, cnt, blk):
    """K1 on one input against its plain version, timed beside its bound,
    on the plan its wrapper picks from the pack's live blocks, then under
    every candidate plan (``fwd_sweep``, entry "bs_fwd": each held to the
    bound and to a second launch's bits first), with the pick's launch
    (registers, shared and spill bytes, CTAs an SM); an f32 case also
    against a float64 product under the pick and under a split
    (``bs_fwd_fidelity``).  The weights are zero
    outside their active blocks, as the served weights are, so the library
    yardstick x @ w computes the same function."""
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels.ops import _row_tile, block_sparse_linear

    M, K = x.shape
    N = w.shape[1]
    nnz = int(cnt.sum())
    bm, Mp = _row_tile(M, 128)
    y = block_sparse_linear(x, w, pack=(idx, cnt), block=(128, blk, blk))
    xp = torch.nn.functional.pad(x, (0, 0, 0, Mp - M))
    ref = bsm.block_sparse_matmul_plain(xp, w, idx, cnt, blk, blk)
    absp = bsm.block_sparse_matmul_plain(xp.abs(), w.abs(), idx, cnt, blk, blk)
    bound = bsm.matmul_error_bound(ref, absp, K)
    del absp

    def check(got):
        err = (got.float() - ref.float()).abs().max().item()
        if x.dtype == torch.bfloat16:
            # both accumulate in f32 and round once to bf16: one bf16 ulp of
            # the largest output at most
            tol = 2.0**-7 * ref.float().abs().max().item()
            ok, ratio = err <= tol, err / max(tol, 1e-30)
        else:  # f32 element by element (bsm.matmul_error_bound)
            ok, ratio, tol = within(torch, got, ref, bound)
        if not ok:
            raise AssertionError(f"K1 {label}: err {err} exceeds its bound ({ratio:.3g}x)")
        return err, ratio, tol

    err, ratio, tol = check(torch.nn.functional.pad(y, (0, 0, 0, Mp - M)))
    # the served function's bytes and flops: its M rows, not the padded Mp
    es = x.element_size()
    n_bytes = es * (M * K + nnz * blk * blk + M * N) + 4 * (idx.numel() + cnt.numel())
    flops = 2.0 * M * nnz * blk * blk
    b_ms, by = bound_ms(n_bytes, flops, peak_of(torch, x.dtype))
    run = lambda plan=None: bsm.block_sparse_matmul(xp, w, idx, cnt, bm=bm, bn=blk, bk=blk,
                                                    plan=plan, live=nnz)
    case = {
        "case": f"{label} {str(x.dtype)[6:]} M={M}->{Mp} K={K} N={N} "
                f"blocks={nnz}/{K // blk * N // blk}",
        "max_abs_err": err, "tol": tol, "err_over_tol": ratio,
        "ms": timer(run),
        "plain_ms": timer(lambda: bsm.block_sparse_matmul_plain(xp, w, idx, cnt, blk, blk), reps=5),
        "library_ms": timer(lambda: x @ w),
        "bound_ms": b_ms, "bound_by": by, "bytes": n_bytes, "flops": flops,
    }
    case.update(fwd_sweep(torch, timer, mm, run, Mp, K, N, 1, x.dtype, case, entry="bs_fwd",
                          check=check, bn_limit=blk, live=nnz, bk=blk))
    if x.dtype == torch.float32:
        case["f64_rms_over_plain"] = bs_fwd_fidelity(
            torch, bsm, f"K1 {case['case']}", run, xp, w, idx, cnt, blk, case["plan"])
    print("K1", json.dumps(case))
    if case["plan"][2] > 1:
        case["merge_case"] = merge_case(torch, timer, mm, case["plan"][2], 1, Mp, N, x.dtype,
                                        case["case"], entry="bs_fwd")
    return case, y


def bs_fwd_fidelity(torch, bsm, tag, run, xp, w, idx, cnt, blk, pick):
    """``f64_fidelity`` of K1 (a 2-D x and pack) or K4 (stacked) in f32
    under the plan's pick and under a split of the pick's tile (the pick's
    own where it splits, else 4): the RMS error against the float64 product
    on the pack's blocks, over the plain f32 version's, at most 8 each.
    Returns {plan: ratio}."""
    live = bsm._dense_mask(idx, cnt, w.shape[-2] // blk, blk, blk)
    ref = lambda: torch.matmul(xp.double(), torch.where(live, w.double(), 0.0))
    plain = (bsm.block_sparse_matmul_plain if xp.dim() == 2
             else bsm.grouped_block_sparse_matmul_plain)
    plans = {tuple(pick), tuple(pick[:2]) + (pick[2] if pick[2] > 1 else 4,)}
    return {str(p): f64_fidelity(torch, f"{tag} plan {p}", lambda p=p: run(p),
                                 lambda: plain(xp, w, idx, cnt, blk, blk), ref)
            for p in sorted(plans)}


def within(torch, got, want, bound):
    """(every element within its bound, worst err/bound, mean bound)."""
    diff = (got.float() - want.float()).abs()
    ratio = (diff / bound.clamp_min(1e-30)).max().item()
    return bool((diff <= bound).all()), ratio, bound.float().mean().item()


def within_tol(torch, tag, got, want, bound):
    """``within``, raising where an element exceeds its bound: (max |got -
    want|, the worst err/tol, the mean tolerance)."""
    ok, ratio, tol = within(torch, got, want, bound)
    if not ok:
        raise AssertionError(f"{tag}: exceeds its bound ({ratio:.3g}x)")
    return (got.float() - want.float()).abs().max().item(), ratio, tol


def uniform_blocks(rng, K, N, blk, density=0.2):
    """A random block mask at ``density`` with column 1 empty."""
    import numpy as np

    nkb, nnb = K // blk, N // blk
    bm = np.zeros(nkb * nnb, bool)
    bm[rng.choice(nkb * nnb, round(density * nkb * nnb), replace=False)] = True
    bm = bm.reshape(nkb, nnb)
    bm[:, 1] = False  # an all-empty column must come out as zeros
    return bm


def k1_cases(torch, timer, bsm, pack_np):
    """K1 at the main paths' shapes: decode (4 rows -> 16) and prefill (512
    rows) over each danube projection shape in bf16, and decode (4 -> 16)
    and prefill (1024) at the MLP shapes in f32 (the MLP runs in the f32
    residual's dtype), 80% block sparsity, one empty column."""
    import numpy as np

    rng = np.random.default_rng(0)
    blk = 128
    out = []
    for K, N, dt, rows in ((2560, 2560, torch.bfloat16, (4, 512)),
                           (2560, 640, torch.bfloat16, (4, 512)),
                           (2560, 6912, torch.bfloat16, (4, 512)),
                           (6912, 2560, torch.bfloat16, (4, 512)),
                           (2560, 6912, torch.float32, (4, 1024)),
                           (6912, 2560, torch.float32, (4, 1024))):
        bm = uniform_blocks(rng, K, N, blk)
        dense = torch.from_numpy(np.repeat(np.repeat(bm, blk, 0), blk, 1)).cuda()
        w = (torch.randn(K, N, device="cuda") / K**0.5 * dense).to(dt)
        idx, cnt = (torch.from_numpy(a).cuda() for a in pack_np(bm))
        for M in rows:
            x = torch.randn(M, K, device="cuda").to(dt)
            case, y = k1_case(torch, timer, bsm, "uniform 20%", x, w, idx, cnt, blk)
            if y[:, blk:2 * blk].abs().max().item() != 0:
                raise AssertionError(f"K1 {case['case']}: the empty column is not zero")
            out.append(case)
    return out


def packed_projections(engine, layer):
    """(name, w, pack entry) of every block-sparse projection of a layer
    (the attention, a hymba layer's SSM projections, the MLP)."""
    for sub in ("attn", "ssm", "mlp"):
        if sub not in engine.pack["layers"][layer]:
            continue
        for name, leaf in engine.pack["layers"][layer][sub].items():
            if not isinstance(leaf, dict):  # a bare dense leaf (the SSM's a_log)
                continue
            if leaf["w"] is not None:
                yield (f"{sub}.{name}", engine.params["layers"][layer][sub][name]["w"],
                       leaf["w"])


def k1_served_cases(torch, timer, bsm, engine, rows=(4, 1024), names=None):
    """K1 on the served model's own ERK packs (layer 0: every projection
    shape at its ERK density, or those in ``names``; bf16 attention, f32
    MLP as served), at a decode step's 4 rows and at the rows of the
    longest prompt bucket."""
    blk = engine.cfg.sparse.kernel_block[2]
    out = []
    for name, w, e in packed_projections(engine, 0):
        if names is not None and name not in names:
            continue
        for M in rows:
            x = torch.randn(M, w.shape[0], device="cuda").to(w.dtype)
            out.append(k1_case(torch, timer, bsm, f"served layer0 {name}", x, w,
                               e["idx"], e["cnt"], blk)[0])
    return out


def k1_decode_ms(torch, bsm, engine):
    """Device time of every K1 launch of one capacity-4 decode step, on the
    served weights and packs of all layers, each on its plan from the pack
    entry's live blocks as the path passes them: the launches (and the
    merges of the split ones) are captured once in a CUDA graph and replayed
    back to back, as the decode step's graph replays them
    (``decode_device_ms``).  Returns (ms, K1 launches, merges)."""
    blk = engine.cfg.sparse.kernel_block[2]
    calls = []
    for layer in range(engine.cfg.n_layers):
        for _, w, e in packed_projections(engine, layer):
            x = torch.randn(16, w.shape[0], device="cuda").to(w.dtype)
            calls.append((x, w, e["idx"], e["cnt"], e["nnz"]))
    run = lambda: [bsm.block_sparse_matmul(x, w, i, c, bm=16, bn=blk, bk=blk, live=n)
                   for x, w, i, c, n in calls]
    m0 = bsm.fwd_merge_launches
    run()
    merges = bsm.fwd_merge_launches - m0
    return graph_ms(torch, run), len(calls), merges


def graph_ms(torch, fn):
    """Device time of ``fn`` replayed from a CUDA graph (no host work between
    its kernels), by CUDA events around the second replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def k9_cases(torch, timer, fa, sched_for):
    """K9 at danube's attention shapes (32 query heads over 8 KV heads,
    G = 4, head_dim 80), at mistral-large's on the paged-serve path (96
    over 8, G = 12, head_dim 128: the full prefill's 592 positions and a
    suffix's 16) and at qwen2-moe-a2.7b's (16 over 16, G = 1, head_dim 128:
    prompts of 100 and 1000), bf16.  The yardstick is PyTorch's
    scaled_dot_product_attention with the same boolean mask (none for the
    softcap case: that call has no softcap).  Each case also reports the
    achieved TFLOP/s, its share of the bound and the launch the kernel gets
    (CTAs resident per SM, registers, shared and spill bytes, warps)."""
    F = torch.nn.functional
    cases = (  # (name, BH, G, d, S, window, softcap)
        ("S=512 causal", 32, 4, 80, 512, 0, 0.0),
        ("S=1024 window=4096 (main-path bucket)", 32, 4, 80, 1024, 4096, 0.0),
        ("S=6144 window=4096", 32, 4, 80, 6144, 4096, 0.0),
        ("S=300 ragged causal", 32, 4, 80, 300, 0, 0.0),
        ("S=512 causal softcap=30", 32, 4, 80, 512, 0, 30.0),
        ("S=592 causal (paged-serve full prefill)", 96, 12, 128, 592, 0, 0.0),
        ("S=16 causal (paged-serve suffix self phase)", 96, 12, 128, 16, 0, 0.0),
        ("S=100 causal (moe-serve prefill)", 16, 1, 128, 100, 0, 0.0),
        ("S=1000 causal (moe-serve prefill)", 16, 1, 128, 1000, 0, 0.0),
    )
    out = []
    for name, BH, G, d, S, window, softcap in cases:
        q = torch.randn(BH, S, d, device="cuda").to(torch.bfloat16)
        k = torch.randn(BH // G, S, d, device="cuda").to(torch.bfloat16)
        v = torch.randn(BH // G, S, d, device="cuda").to(torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=softcap, kv_groups=G,
                  return_lse=True)
        o, lse = fa.flash_attention(q, k, v, **kw)
        # the plain version at the kernel's blocks and schedule, on the card
        bq, bk = fa.effective_blocks(S, S)
        Sp = -(-S // bq) * bq
        sched = sched_for(S, S, bq, bk, True, window, 0)
        pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
        pargs = (pad(q), pad(k), pad(v),
                 torch.from_numpy(sched["kv_idx"]).cuda(),
                 torch.from_numpy(sched["kv_cnt"]).cuda())
        pkw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
                   scale=d**-0.5, softcap=softcap, kv_groups=G)
        po, plse = fa.flash_attention_plain(*pargs, **pkw)
        pa, _ = fa.flash_attention_plain(pargs[0], pargs[1], pargs[2].abs(),
                                         *pargs[3:], **pkw)
        po, pa, plse = po[:, :S], pa[:, :S], plse[:, :S]
        # o, element by element: the bound of rounding p to bf16 in the
        # kernel and o to bf16 on both sides (fa.o_error_bound); lse: f32 in
        # both
        diff = (o.float() - po.float()).abs()
        bound = fa.o_error_bound(po, pa)
        err_o, err_l = diff.max().item(), (lse - plse).abs().max().item()
        ratio = (diff / bound.clamp_min(1e-30)).max().item()
        if not (bool((diff <= bound).all()) and err_l <= 1e-3):
            raise AssertionError(f"K9 {name}: o exceeds its per-element bound "
                                 f"{ratio:.3g}-fold (max err {err_o}), lse err {err_l}")
        pos = torch.arange(S, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        live = int(mask.sum())
        flops = 4.0 * d * live * BH
        b_ms, by = bound_ms(2 * (2 * BH * S * d + 2 * (BH // G) * S * d) + 4 * BH * S, flops)
        lib_ms = None
        if not softcap:
            q4, k4, v4 = (t.view(1, -1, S, d) for t in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True), reps=5)
        ms = timer(lambda: fa.flash_fwd(*pargs, **pkw), reps=5)
        case = {
            "case": f"{name} BH={BH} G={G} d={d}",
            "max_abs_err": err_o, "lse_err": err_l, "lse_tol": 1e-3,
            "tol": "2**-7 |o| + 1.25 * 2**-8 (p @ |v|) / l, per element",
            "err_over_tol": ratio, "mean_abs_o": po.float().abs().mean().item(),
            "mean_tol": bound.mean().item(),
            "ms": ms,
            "plain_ms": timer(lambda: fa.flash_attention_plain(*pargs, **pkw),
                              reps=2, warmup=1),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by,
            "tflop_s": flops / ms / 1e9, "share_of_bound": b_ms / ms,
            "launch": fa.launch_info("flash_fwd", d, int(sched["kv_idx"].shape[1])),
        }
        print("K9", json.dumps(case))
        out.append(case)
    return out


def main_path(torch, timer, bsm, fa):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (
        configure_kernel,
        init_serving_state,
        staggered_requests,
    )
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel="block_sparse",
                           block=128, attn_kernel="flash_tight")
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    engine = ServeEngine(cfg, params, capacity=4, max_len=2048, masks=masks,
                         pack=pack)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"main: full h2o-danube-1.8b ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) initialised in {init_s:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    # warm-up (cuBLAS handles, allocator), before the counted run
    for r in staggered_requests(cfg, 2, prompt_lens=(100,), gen_lens=(2,), seed=1):
        engine.submit(r)
    engine.run()

    reqs = staggered_requests(cfg, 8, prompt_lens=(100, 300, 1000),
                              gen_lens=(32,), seed=0)
    engine = ServeEngine(cfg, engine.params, capacity=4, max_len=2048,
                         masks=masks, pack=pack)
    for r in reqs:
        engine.submit(r)
    bsm.launches = bsm.fwd_merge_launches = 0
    fa.launches = 0
    stats = engine.run()
    launches = {"block_sparse_fwd": bsm.launches, "flash_fwd": fa.launches,
                "block_sparse_fwd_merge": bsm.fwd_merge_launches}
    stats["prefill_ms"] = 1e3 * stats["prefill_s"] / stats["prefills"]
    stats["generated"] = {r.rid: list(r.generated) for r in reqs}
    print("main: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "quarantined",
        "failed", "wall_s", "tok_per_s", "prefill_s", "decode_step_s")}))
    print(f"main: prefill {1e3 * stats['prefill_s'] / stats['prefills']:.2f} "
          f"ms/request, decode {1e3 * stats['decode_step_s']:.2f} ms/step "
          f"(capacity 4), {stats['tok_per_s']:.2f} tok/s end to end; "
          f"launches {launches}")
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != 32:
            raise AssertionError(f"request {r.rid}: {r.status} with "
                                 f"{len(r.generated)} tokens")
    if stats["quarantined"] or stats["failed"]:
        raise AssertionError(f"quarantined/failed slots: {stats}")
    for name in ("block_sparse_fwd", "flash_fwd"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # the kernel path against the plain dense path on the same weights: a
    # prompt's prefill logits and one decode step
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))
    toks = torch.from_numpy(reqs[0].tokens).long().cuda()[None]
    res = {}
    for name, c in (("kernel", cfg), ("dense", dense)):
        logits, caches = lm_prefill(engine.params, c, {"tokens": toks}, 128,
                                    masks=masks, pack=pack)
        nxt = logits[:, -1].argmax(-1)[:, None]
        step, _ = lm_decode(engine.params, c, caches, nxt, toks.shape[1],
                            masks=masks, pack=pack)
        V = cfg.vocab_size
        res[name] = (logits.float()[..., :V], step.float()[..., :V])
    for i, what in enumerate(("prefill", "decode")):
        a, b = res["kernel"][i], res["dense"][i]
        if not bool(torch.isfinite(a).all()) or a.shape != (1, 1, cfg.vocab_size):
            raise AssertionError(f"{what} logits not finite or of the wrong shape")
        err = (a - b).abs().max().item()
        tol = 2e-2 * b.abs().max().item()
        top_a, top_b = a.flatten().topk(2), b.flatten().topk(2)
        gap = (top_b.values[0] - top_b.values[1]).item()
        print(f"main: {what} logits, kernel path vs dense path: max err "
              f"{err:.4g} (tol {tol:.4g}); top-1 {int(top_a.indices[0])} vs "
              f"{int(top_b.indices[0])}, the dense path's top two "
              f"{top_b.indices.tolist()} {gap:.4g} apart, the kernel path's "
              f"{top_a.indices.tolist()} {(top_a.values[0] - top_a.values[1]).item():.4g} apart")
        stats[f"{what}_top2_gap_dense"] = gap
        if err > tol:
            raise AssertionError(f"{what} logits differ from the dense path")
    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode)
    k1_ms, n_calls, n_merges = k1_decode_ms(torch, bsm, engine)
    stats["k1_decode_step_ms"], stats["k1_decode_step_merges"] = k1_ms, n_merges
    print(f"main: K1 in one decode step: {n_calls} launches and {n_merges} split merges on "
          f"the served packs, {k1_ms:.3f} ms device time (CUDA-graph replay), "
          f"{k1_ms / stats['decode_step_device_ms']:.1%} of the step's device time")
    served = k1_served_cases(torch, timer, bsm, engine)
    return stats, launches, served


def decode_device_ms(torch, engine, lm_decode, label="main"):
    """Device time of one full-capacity decode step against its host-clock
    time.  The step is captured once in a CUDA graph; a replay runs the same
    kernels back to back with no host work between them, so the events
    around it time the step's device work alone.  Runs after the served
    requests: it only rewrites cache slots past their end (a paged engine's
    released slots hold sentinel tables, so their writes drop; the step
    gathers and attends the same shapes)."""
    dev = engine.device
    tok = torch.from_numpy(engine.cur_tok[:, None]).to(dev)
    pos = torch.from_numpy(engine.pos).to(dev)
    tables = ({g: torch.from_numpy(t).to(dev) for g, t in engine.tables.items()}
              if engine.paged else None)
    step = lambda: lm_decode(engine.params, engine.cfg, engine.caches, tok, pos,
                             masks=engine.masks, pack=engine.pack, tables=tables)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_ms = graph_ms(torch, step)
    print(f"{label}: decode step at capacity 4: {dev_ms:.2f} ms device time "
          f"(CUDA-graph replay), {wall_ms:.2f} ms host clock, card idle "
          f"{1 - dev_ms / wall_ms:.1%} of the host-driven step")
    return dev_ms


def bs_bwd_cases(torch, timer, bsm, pack_np, state, cfg, names=None, uniform=True):
    """K2 (dx on the CSR) and K3 (dw on the Top-KAST superset CSC) on the
    training path's own packs: layer 0's seven projections at M = 2048 rows
    (one microbatch of 2 x 1024), bf16 for attention and f32 for the MLP as
    the path runs them; plus a uniform-20% bf16 case with an empty column
    and a 10% superset.  Each output element by element within
    ``bsm.matmul_error_bound``.  Both run on the GEMM core, each with its
    plan on the pack's live blocks as the path passes them (K2 the entry's
    nnz, K3 its bnnz): every candidate plan forced and timed
    (``fwd_sweep``, entries "bs_dx" and "bs_dw", each held to the bound and
    to a second launch's bits first), the f32 cases against a float64
    product (``bs_fwd_fidelity`` on w^T, ``f64_fidelity``), and the merge of
    a split pick (``merge_case``, ``bs_merge_case``).  ``names`` keeps
    those projections of layer 0 (a hymba layer's SSM projections run f32
    as its MLP); ``uniform`` adds the uniform case.  Returns (K2 cases, K3
    cases, K3's merge cases, K2's merge cases)."""
    import numpy as np

    from repro_torch.kernels import masked_matmul as mm

    blk, M = cfg.sparse.kernel_block[2], 2048
    items = []
    for sub in ("attn", "ssm", "mlp"):
        if sub not in state["pack"]["layers"][0]:
            continue
        dt = torch.bfloat16 if sub == "attn" else torch.float32
        for name, leaf in state["pack"]["layers"][0][sub].items():
            if (not isinstance(leaf, dict) or leaf["w"] is None
                    or names is not None and f"{sub}.{name}" not in names):
                continue
            w = state["params"]["layers"][0][sub][name]["w"].to(dt)
            items.append((f"train layer0 {sub}.{name}", w, leaf["w"]))
    rng = np.random.default_rng(1)
    bm = uniform_blocks(rng, 2560, 2560, blk)
    sup = bm | (rng.random(bm.shape) < 0.1)
    dense = torch.from_numpy(np.repeat(np.repeat(bm, blk, 0), blk, 1)).cuda()
    w = (torch.randn(2560, 2560, device="cuda") / 2560**0.5 * dense).to(torch.bfloat16)
    t = lambda a: torch.from_numpy(a).cuda()
    (ridx, rcnt), (bidx, bcnt) = pack_np(bm.T), pack_np(sup)
    if uniform:
        items.append(("uniform 20% + 10% superset", w,
                      {"ridx": t(ridx), "rcnt": t(rcnt), "bidx": t(bidx), "bcnt": t(bcnt),
                       "nnz": int(bm.sum()), "bnnz": int(sup.sum())}))
    k2, k3, merges, dx_merges = [], [], [], []
    for label, w, e in items:
        K, N = w.shape
        dt, es = w.dtype, w.element_size()
        x = torch.randn(M, K, device="cuda").to(dt)
        g = torch.randn(M, N, device="cuda").to(dt)
        ridx, rcnt, bidx, bcnt = e["ridx"], e["rcnt"], e["bidx"], e["bcnt"]
        nnz, bnnz = int(rcnt.sum()), int(bcnt.sum())
        if (nnz, bnnz) != (e["nnz"], e["bnnz"]):
            raise AssertionError(f"K2/K3 {label}: the entry's nnz, bnnz {e['nnz']}, "
                                 f"{e['bnnz']}; rcnt, bcnt sum {nnz}, {bnnz}")
        run = lambda plan=None: bsm.block_sparse_dx(g, w, ridx, rcnt, bm=128, bn=blk, bk=blk,
                                                    plan=plan, live=nnz)
        want = bsm.block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk)
        bound = bsm.matmul_error_bound(want, bsm.block_sparse_dx_plain(
            g.abs().float(), w.abs().float(), ridx, rcnt, blk, blk), N)

        def check_dx(got):
            ok, ratio, tol = within(torch, got, want, bound)
            if not ok:
                raise AssertionError(f"K2 {label}: exceeds its bound ({ratio:.3g}x)")
            return (got.float() - want.float()).abs().max().item(), ratio, tol

        tag = f"{label} {str(dt)[6:]} M={M} K={K} N={N} blocks={nnz}/{K // blk * N // blk}"
        case = kernel_case(
            torch, timer, "K2", tag, run,
            lambda: bsm.block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk), lambda: g @ w.T,
            lambda: check_dx(run()),
            es * (M * N + nnz * blk * blk + M * K) + 4 * (ridx.numel() + rcnt.numel()),
            2.0 * M * nnz * blk * blk, dt)
        case.update(fwd_sweep(torch, timer, mm, run, M, N, K, 1, dt, case, entry="bs_dx",
                              check=check_dx, bn_limit=blk, live=nnz, bk=blk))
        del want, bound
        if dt == torch.float32:
            case["f64_rms_over_plain"] = bs_fwd_fidelity(
                torch, bsm, f"K2 {tag}", run, g, w.T, ridx, rcnt, blk, case["plan"])
        print("K2 plans", json.dumps(case))
        k2.append(case)
        if case["plan"][2] > 1:
            dx_merges.append(merge_case(torch, timer, mm, case["plan"][2], 1, M, K, dt, tag,
                                        entry="bs_dx"))
        run = lambda plan=None: bsm.block_sparse_dw(x, g, bidx, bcnt, bn=blk, bk=blk, plan=plan,
                                                    live=bnnz)
        want = bsm.block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk)
        absp = bsm.block_sparse_dw_plain(x.abs().float(), g.abs().float(), bidx, bcnt, blk, blk)
        bound = bsm.matmul_error_bound(want, absp, M)

        def check(got):
            ok, ratio, tol = within(torch, got, want, bound)
            if not ok:
                raise AssertionError(f"K3 {label}: exceeds its bound ({ratio:.3g}x)")
            return (got.float() - want.float()).abs().max().item(), ratio, tol

        tag = (f"{label} {str(dt)[6:]} M={M} K={K} N={N} superset blocks={bnnz}/"
               f"{K // blk * N // blk}")
        # the function's output is the dense (K, N) dw: written once
        case = kernel_case(
            torch, timer, "K3", tag, run,
            lambda: bsm.block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk), lambda: x.T @ g,
            lambda: check(run()),
            es * (M * K + M * N + K * N) + 4 * (bidx.numel() + bcnt.numel()),
            2.0 * M * bnnz * blk * blk, dt)
        case.update(fwd_sweep(torch, timer, mm, run, K, M, N, 1, dt, case, entry="bs_dw",
                              check=check, bn_limit=blk, live=bnnz))
        case["dense_tflop_s"] = 2.0 * M * bnnz * blk * blk / case["ms"] / 1e9
        del want, absp, bound
        if dt == torch.float32:
            case["f64_rms_over_plain"] = f64_fidelity(
                torch, f"K3 {tag}", run,
                lambda: bsm.block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk),
                lambda: torch.where(bsm._dense_mask(bidx, bcnt, K // blk, blk, blk),
                                    x.double().T @ g.double(), 0.0))
        print("K3 plans", json.dumps(case))
        k3.append(case)
        if case["plan"][2] > 1:
            merges.append(bs_merge_case(torch, timer, bsm, case["plan"][2], bidx, bcnt, K, N,
                                        dt, blk, tag))
    return k2, k3, merges, dx_merges


def bs_merge_case(torch, timer, bsm, n_split, idx, cnt, K, N, dt, blk, tag):
    """The split merge of K3 (a 2-D pack) or K6 (a stacked one) at a split
    pick's shape: random packed partials (n_split, G, N/bn, width, bk, bn)
    summed in order into a zeroed dw's live blocks, bit for bit
    ``bs_dw_merge_plain`` (every element off the pack left at 0), timed
    beside its byte bound (the live blocks' partials read once, dw's live
    blocks written once, the pack); no one PyTorch call computes it."""
    ix, cn = (idx, cnt) if idx.dim() == 3 else (idx[None], cnt[None])
    G, nnb, width = ix.shape
    live = int(cn.sum())
    part = torch.randn(n_split, G, nnb, width, blk, blk, device="cuda")
    shape = (G, K, N) if idx.dim() == 3 else (K, N)
    out = torch.zeros(shape, dtype=dt, device="cuda")
    merge = lambda: bsm.bs_dw_merge(part, idx, cnt, out)
    plain = lambda: bsm.bs_dw_merge_plain(part, idx, cnt, torch.zeros_like(out))

    def check():
        out.zero_()
        if not torch.equal(merge().float(), plain().float()):
            raise AssertionError(f"K3/K6 merge {tag}: differs from the ordered plain sum")
        return 0.0, 0.0, 0.0

    n_bytes = ((4 * n_split + out.element_size()) * live * blk * blk
               + 4 * (idx.numel() + cnt.numel()))
    return kernel_case(torch, timer, "bs dw merge", f"{tag} n_split={n_split}", merge, plain,
                       None, check, n_bytes, 0.0, dt)


def bs_fused_merge_case(torch, timer, bsm, n_split, idx, cnt, w, mom, blk, tag):
    """The split merge of K7 (a 2-D pack) or K8 (a stacked one) at a split
    pick's shape, sr on (the path's): random packed partials (n_split, G,
    N/bn, width, bk, bn) summed in order, the momentum folded, sr, one
    rounding, into a zeroed output's live blocks, bit for bit
    ``bs_dw_fused_merge_plain`` (every element off the pack left at 0),
    timed beside its byte bound (the live blocks' partials, w and mom read
    once, the output's live blocks written once, the pack); no one PyTorch
    call computes it."""
    ix, cn = (idx, cnt) if idx.dim() == 3 else (idx[None], cnt[None])
    G, nnb, width = ix.shape
    live = int(cn.sum())
    part = torch.randn(n_split, G, nnb, width, blk, blk, device="cuda")
    out = torch.zeros(w.shape, dtype=w.dtype, device="cuda")
    kw = dict(mu=FUSED_MU, wd=FUSED_WD, sr=True)
    merge = lambda: bsm.bs_dw_fused_merge(part, idx, cnt, w, mom, out, FUSED_SEED, **kw)
    plain = lambda: bsm.bs_dw_fused_merge_plain(part, idx, cnt, w, mom, torch.zeros_like(out),
                                                FUSED_SEED, **kw)

    def check():
        out.zero_()
        if not torch.equal(merge().float(), plain().float()):
            raise AssertionError(f"K7/K8 merge {tag}: differs from its plain version")
        return 0.0, 0.0, 0.0

    n_bytes = ((4 * n_split + 2 * w.element_size() + mom.element_size()) * live * blk * blk
               + 4 * (idx.numel() + cnt.numel()))
    return kernel_case(torch, timer, "bs dw fused merge", f"{tag} n_split={n_split}", merge,
                       plain, None, check, n_bytes, 0.0, w.dtype)


def bs_fused_sweep(torch, timer, bsm, case, x, g, bidx, bcnt, w, mom, sr, blk, sup, absp, acc,
                   tag):
    """K7 (x (M, K)) or K8 (x (G, M, K)) under every candidate plan on the
    fused kernel's own slots (``fwd_sweep``, entry "bs_dw" with the case's
    mom and output types), added to ``case``: sr off each plan's m_new
    within ``mm.fused_error_bound`` of the plain version, sr on bit for bit
    ``sr_to_bf16`` of the same plan's own f32 m_new and on the bf16 grid,
    zeros off the superset (``fused_checks``); the f32 cases' RMS error
    against the epilogue on a float64 product over the plain version's
    (``f64_fidelity``, sr off).  Returns the fused merge's case
    (``bs_fused_merge_case``) where the pick splits, sr on."""
    from repro_torch.kernels import masked_matmul as mm

    grouped = x.dim() == 3
    M, K, N = x.shape[-2], x.shape[-1], g.shape[-1]
    G = x.shape[0] if grouped else 1
    live = int(bcnt.sum())
    fn, plain_fn = ((bsm.grouped_block_sparse_dw_fused, bsm.grouped_block_sparse_dw_fused_plain)
                    if grouped else (bsm.block_sparse_dw_fused, bsm.block_sparse_dw_fused_plain))
    kw = dict(mu=FUSED_MU, wd=FUSED_WD, bn=blk, bk=blk)
    run = lambda p, s=sr, o=None: fn(x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=s, out_dtype=o,
                                     plan=p, live=live, **kw)
    plain = lambda: plain_fn(x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=False, **kw)
    want = None if sr else plain()
    bound = lambda want: mm.fused_error_bound(want, absp, M, FUSED_MU, FUSED_WD, mom, w, acc,
                                              sup)
    gid = mm._gid(K, N, "cuda", G=G if grouped else None)
    check_plan = lambda got, p: fused_checks(
        torch, f"{tag} plan {list(p)}", lambda: got, lambda: want,
        (lambda: run(p, False, torch.float32)) if sr else None, lambda: gid, sup, bound)
    case.update(fwd_sweep(torch, timer, mm, run, K, M, N, G, x.dtype, case, entry="bs_dw",
                          bn_limit=blk, live=live, kinds=(mom.dtype, w.dtype),
                          check_plan=check_plan))
    case["dense_tflop_s"] = 2.0 * G * M * K * N / case["ms"] / 1e9
    del want
    if x.dtype == torch.float32 and not sr:
        case["f64_rms_over_plain"] = f64_fidelity(
            torch, tag, lambda: run(None), plain,
            lambda: torch.where(sup, FUSED_MU * mom.double() + x.double().transpose(-1, -2)
                                @ g.double() + FUSED_WD * w.double(), 0.0))
    print(tag, "plans", json.dumps(case))
    if case["plan"][2] == 1 or not sr:
        return []
    return [bs_fused_merge_case(torch, timer, bsm, case["plan"][2], bidx, bcnt, w, mom, blk,
                                tag)]


def bs_merges(torch, cfg, state, tokens, entry="bs_dw"):
    """The split merges of one pass over ``tokens`` tokens on ``state``'s
    pack (``state["params"]`` and ``state["pack"]``): K3/K6's of a backward
    (``entry`` "bs_dw": each entry's plan on its wgrad pack's live blocks,
    bnnz where it carries a superset, else nnz), K7/K8's of a fused backward
    ("bs_dw_fused": the same, on the fused kernel's slots), K2/K5's ("bs_dx": on the
    forward pack's nnz) or K1/K4's of a forward ("bs_fwd": likewise); the
    attention in the compute dtype and the MLP, the shared MLP and the
    expert banks in f32 (as the model calls them), a bank's rows its
    capacity; rows padded to the row tile."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.core.pack import pack_entries
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels.ops import _row_tile
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.moe import capacity

    params = tree_paths(state["params"])
    bm, bn, bk = cfg.sparse.kernel_block
    dev = torch.cuda.current_device()
    n = 0
    for name, e in pack_entries(state["pack"]):
        w = params[name]
        G, (K, N) = (w.shape[0] if w.dim() == 3 else 1), w.shape[-2:]
        _, Mp = _row_tile(capacity(tokens, cfg) if w.dim() == 3 else tokens, bm)
        dt = (compute_dtype(cfg) if "/attn/" in f"/{name}" or cfg.frontend == "frames"
              else torch.float32)
        if entry in ("bs_dw", "bs_dw_fused"):
            live = e["bnnz"] if "bidx" in e else e["nnz"]
            # K7/K8 on the fused kernel's slots: the fused path's bf16 momentum
            # (fused_opt), m_new in the weight's dtype
            kinds = (torch.bfloat16, dt) if entry == "bs_dw_fused" else ()
            plan = bsm._dw_plan_for(Mp, K, N, G, dt, min(bn, N), live, dev, *kinds)
        elif entry == "bs_dx":
            plan = bsm._dx_plan_for(Mp, K, N, G, dt, min(bk, K), min(bn, N), e["nnz"], dev)
        else:
            plan = bsm._fwd_plan_for(Mp, K, N, G, dt, min(bk, K), min(bn, N), e["nnz"], dev)
        n += plan[2] > 1
    return n


BS_ENTRIES = ("bs_fwd", "bs_dx", "bs_dw")  # the block-sparse plans that may split


def block_sparse_ms(prof):
    """Device ms of K1/K4, K2/K5 and K3/K6 in a profiler's CUDA events (the
    grouped twins run the same kernels), and of the merges of their splits
    (K1's and K2's on the masked forward's merge kernel)."""
    names = {"block_sparse_fwd": "block_sparse_fwd_gemm_kernel",
             "block_sparse_dx": "block_sparse_dx_gemm_kernel",
             "block_sparse_dw": "block_sparse_dw_gemm_kernel",
             "block_sparse_dw_merge": "block_sparse_dw_merge_kernel",
             "fwd_dx_merge": "masked_merge_kernel"}
    return {n: sum(e.self_device_time_total for e in prof if k in e.key) / 1e3
            for n, k in names.items()}


DANUBE_FLASH_BWD = (("S=1024 window=4096 (main-path shape)", 64, 1024, 4096, 0.0),
                    ("S=512 window=256", 32, 512, 256, 0.0),
                    ("S=300 ragged causal", 32, 300, 0, 0.0),
                    ("S=512 causal softcap=30 (parity only)", 32, 512, 0, 30.0))


def bwd_launch(torch, fa, kind, sched, kw, n_rows, d, Sp):
    """The launch K10 (``kind`` "dq") or K11 ("dkv") gets at one case: its
    plan (pair, n_split), CTAs, the longest CTA's walk in 64-row tiles,
    and from the runtime CTAs resident per SM, registers, shared and spill
    bytes and warps a CTA."""
    idx, cnt = (sched["kv_idx"], sched["kv_cnt"]) if kind == "dq" else (sched["q_idx"],
                                                                        sched["q_cnt"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    pair, n_split = fa._bwd_plan_for(kind, Sp, Sp, d, n_rows, n_sm, **kw)
    walks = fa.bwd_walks(kind, idx, cnt, bq=kw["bq"], bk=kw["bk"], causal=kw["causal"],
                         window=kw["window"], q_offset=kw["q_offset"], sk=kw["sk"],
                         groups=kw["kv_groups"], unit_rows=fa.bwd_unit_rows(kind, d),
                         pair=pair, n_split=n_split)
    return {"pair": pair, "n_split": n_split, "ctas": len(walks) * n_rows,
            "longest_walk_tiles": max(sum(len(st) for _, _, st in units) for _, units in walks),
            **fa.launch_info(f"flash_{kind}", d, int(idx.shape[1]))}


def plan_sweep(timer, fa, fn, args, kw):
    """ms of one K10 / K11 call under every candidate plan of
    ``fa.bwd_plan`` (pair, n_split), with the plan forced for the timing:
    {"pair=P split=S": ms}."""
    chosen = fa._bwd_plan_for
    out = {}
    try:
        for n_split in range(1, fa.BWD_MAX_SPLIT + 1):
            for pair in (False, True):
                fa._bwd_plan_for = lambda *a, **k: (pair, n_split)
                out[f"pair={int(pair)} split={n_split}"] = timer(lambda: fn(*args, **kw), reps=5)
    finally:
        fa._bwd_plan_for = chosen
    return out


def flash_bwd_cases(torch, timer, fa, G=4, d=80, cases=DANUBE_FLASH_BWD):
    """K10 (dq) and K11 (dk, dv), by default at danube's attention shapes
    (32 query heads per sequence over 8 KV heads, G = 4, head_dim 80,
    bf16): the training microbatch's S = 1024 under the window 4096 (BH =
    64), a 256 window at S = 512, a ragged causal S = 300, and a softcap-30
    case (parity only: PyTorch's attention has no softcap).  ``cases``:
    (name, query heads BH, S, window, softcap).  Each gradient element by
    element within ``fa.grad_error_bound``; the yardstick is the backward
    of scaled_dot_product_attention with the same mask and enable_gqa,
    which computes dq, dk and dv together (timed as a pair), and, where the
    mask is purely causal, the same call with is_causal=True
    (``library_causal_ms``).  Each case also reports the achieved TFLOP/s,
    its share of the bound, the launch (``bwd_launch``) and each kernel's
    time under every candidate plan of ``fa.bwd_plan`` (``plan_sweep``),
    with whether the plan it chose was the fastest of them."""
    from repro_torch.core.attn_sched import sched_for

    F = torch.nn.functional
    k10, k11 = [], []
    for name, BH, S, window, softcap in cases:
        r = lambda n: torch.randn(n, S, d, device="cuda").to(torch.bfloat16)
        q, k, v, do = r(BH), r(BH // G), r(BH // G), r(BH)
        bq, bk = fa.effective_blocks(S, S)
        Sp = -(-S // bq) * bq
        pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
        qp, kp, vp, dop = pad(q), pad(k), pad(v), pad(do)
        sched = fa._schedule_on(q.device, S, S, bq, bk, True, window, 0)
        kw = dict(bq=bq, bk=bk, causal=True, window=window, q_offset=0, sk=S,
                  scale=d**-0.5, softcap=softcap, kv_groups=G)
        o, lse = fa.flash_fwd(qp, kp, vp, sched[0], sched[1], **kw)
        delta = (dop.float() * o.float()).sum(-1)
        dq_args = (qp, kp, vp, dop, lse, delta, sched[0], sched[1])
        dkv_args = (qp, kp, vp, dop, lse, delta, sched[2], sched[3])
        dq = fa.flash_dq(*dq_args, **kw)
        dk, dv = fa.flash_dkv(*dkv_args, **kw)
        blocks = fa._schedule_mask(sched[0], sched[1], Sp // bk, q.device)
        plain_args = (qp, kp, vp, dop, lse, delta, blocks)
        want_q, want_k, want_v, rq, rk, rv, eq, ek, ev = fa.flash_bwd_plain(
            *plain_args, with_abs=True, **kw)
        checks = {}
        for what, got, want, rnd, err in (("dq", dq, want_q, rq, eq), ("dk", dk, want_k, rk, ek),
                                          ("dv", dv, want_v, rv, ev)):
            ok, ratio, tol = within(torch, got, want, fa.grad_error_bound(want, rnd, err))
            if not ok:
                raise AssertionError(f"K10/K11 {name} {what}: exceeds its bound ({ratio:.3g}x)")
            checks[what] = ((got.float() - want.float()).abs().max().item(), ratio, tol)
        pos = torch.arange(S, device="cuda")
        mask = pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        live = int(mask.sum())
        lib_ms = lib_causal_ms = None
        if not softcap:
            q4, k4, v4 = (t.view(1, -1, S, d).detach().requires_grad_(True) for t in (q, k, v))
            do4 = do.view(1, BH, S, d)
            out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)
            lib_ms = timer(lambda: torch.autograd.grad(out, (q4, k4, v4), do4,
                                                       retain_graph=True), reps=5)
            if not window or window >= S:
                out_c = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                       enable_gqa=True)
                lib_causal_ms = timer(lambda: torch.autograd.grad(out_c, (q4, k4, v4), do4,
                                                                  retain_graph=True), reps=5)
        plain_ms = timer(lambda: fa.flash_bwd_plain(*plain_args, **kw), reps=2, warmup=1)
        BKV = BH // G
        sched_np = sched_for(S, S, bq, bk, True, window, 0)
        for kernel, kind, fn, args, what, n_bytes, flops in (
                ("K10", "dq", fa.flash_dq, dq_args, ("dq",),
                 2 * (3 * BH * S * d + 2 * BKV * S * d) + 8 * BH * S, 6.0 * d * live * BH),
                ("K11", "dkv", fa.flash_dkv, dkv_args, ("dk", "dv"),
                 2 * (2 * BH * S * d + 4 * BKV * S * d) + 8 * BH * S, 8.0 * d * live * BH)):
            b_ms, by = bound_ms(n_bytes, flops)
            ms = timer(lambda: fn(*args, **kw), reps=5)
            launch = bwd_launch(torch, fa, kind, sched_np, kw, BH if kind == "dq" else BKV, d, Sp)
            plans = plan_sweep(timer, fa, fn, args, kw)
            mine = f"pair={int(launch['pair'])} split={launch['n_split']}"
            case = {"case": f"{name} BH={BH} G={G} d={d}",
                    "max_abs_err": max(checks[w_][0] for w_ in what),
                    "err_over_tol": max(checks[w_][1] for w_ in what),
                    "mean_tol": {w_: checks[w_][2] for w_ in what},
                    "ms": ms, "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
                    "library_ms": lib_ms, "library_causal_ms": lib_causal_ms,
                    "library_covers": "dq, dk and dv",
                    "bound_ms": b_ms, "bound_by": by,
                    "tflop_s": flops / ms / 1e9, "share_of_bound": b_ms / ms,
                    "launch": launch, "plans_ms": plans,
                    "plan_is_fastest": plans[mine] == min(plans.values())}
            print(kernel, json.dumps(case))
            (k10 if kernel == "K10" else k11).append(case)
    return k10, k11


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, DELTA_T = 6, 8, 1024, 2


def train_config():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel="block_sparse",
                           block=128, attn_kernel="flash_tight")
    return dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, method="rigl", delta_t=DELTA_T))


def train_dense_check(torch, cfg, state, names=("layers/0/mlp/wi/w", "layers/0/attn/wq/w"),
                      label="train", batch=2, seq=TRAIN_SEQ):
    """The step-0 loss of one microbatch (``batch`` x ``seq``, by default
    2 x 1024) and the gradients of
    ``names`` (by default an MLP and an attention weight of layer 0), on
    the kernel path, against the plain dense path on the same weights
    (masked dense matmuls, the plain masked softmax).  An MoE model's
    routing on the dense path is pinned to the kernel path's picks
    (``patch_route``; with remat the checkpoint reruns take the same picks
    in the same order).  The kernel path's weight gradient is the dense
    one restricted to the superset B, and exactly zero outside it."""
    from repro_torch.core.masks import apply_masks, tree_map, tree_paths
    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.model import lm_loss

    b = batch_for(cfg, 0, batch, seq, learnable=True, device="cuda")
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))

    def loss_and_grads(c, params, record=None, force=None, **kw):
        leaves = {}

        def pick(n, t):
            if n in names:
                t = leaves[n] = t.detach().requires_grad_(True)
            return t

        restore = patch_route(record, force)
        try:
            loss = lm_loss(tree_map(pick, params), c, b, **kw)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        finally:
            restore()
        return loss.item(), dict(zip(names, grads))

    picks = []
    lk, gk = loss_and_grads(cfg, state["params"], record=picks, masks=state["masks"],
                            pack=state["pack"])
    ld, gd = loss_and_grads(dense, apply_masks(state["params"], state["masks"]),
                            force=picks or None)
    bwd = tree_paths(state["bwd_masks"])
    out = {"loss_kernel": lk, "loss_dense": ld, "loss_rel_err": abs(lk - ld) / abs(ld)}
    if picks:
        out["route_calls"] = len(picks)
    # tolerances: both paths run attention in bf16 and round at other
    # points (flash's p vs the softmax weights, in another order), so the
    # loss moves by ~1e-4 relative and a weight gradient, a sum over 2048
    # rows of products of such activations, by up to ~1% in norm
    if not out["loss_rel_err"] <= 1e-3:
        raise AssertionError(f"{label}: step-0 loss: kernel {lk} vs dense {ld}")
    for n in names:
        ref = gd[n] * bwd[n] if n in bwd else gd[n]
        rel = ((gk[n] - ref).norm() / ref.norm()).item()
        outside = gk[n][~bwd[n]].abs().max().item() if n in bwd and (~bwd[n]).any() else 0.0
        out[f"{n} grad_rel_err"] = rel
        if not (rel <= 2e-2 and outside == 0.0):
            raise AssertionError(f"{label}: step-0 gradient of {n}: rel err {rel}, "
                                 f"{outside} outside the superset")
    print(f"{label}: step 0, kernel path vs dense path{', routing pinned' if picks else ''}:",
          json.dumps(out))
    return out


def train_path(torch, bsm, fa, mm, cfg, merges):
    """``train_loop`` at full width and depth, with the launch counters set
    to 0 just before it and read after every step.  ``merges``: the K1, K2
    and K3 split merges of the initial pack, {"bs_fwd": (a microbatch's
    forward, the full batch's), "bs_dx": (...), "bs_dw": (...)}
    (``bs_merges``); each step's own come from the pack it ran on."""
    from repro_torch.core.masks import block_mask_of, tree_paths
    from repro_torch.core.pack import pack_mismatch, validate_pack
    from repro_torch.launch.train import train_loop

    counters = (("block_sparse_fwd", bsm, "launches"), ("block_sparse_dx", bsm, "dx_launches"),
                ("block_sparse_dw", bsm, "dw_launches"),
                ("block_sparse_fwd_merge", bsm, "fwd_merge_launches"),
                ("block_sparse_dx_merge", bsm, "dx_merge_launches"),
                ("block_sparse_dw_merge", bsm, "dw_merge_launches"),
                ("flash_fwd", fa, "launches"),
                ("flash_dq", fa, "dq_launches"), ("flash_dkv", fa, "dkv_launches"))
    read = lambda: {n: getattr(mod, a) for n, mod, a in counters}
    mb, n_proj, n_attn = cfg.microbatches, 7 * cfg.n_layers, cfg.n_layers

    def expect(is_update, n_merges):
        # remat reruns each block's forward in the backward: K1 (with its
        # merges) and K9 twice; the update step's gradient is one pass over
        # the full batch
        k = 1 if is_update else mb
        per = lambda e: n_merges[e][1] if is_update else n_merges[e][0] * mb
        return {"block_sparse_fwd": 2 * n_proj * k, "block_sparse_dx": n_proj * k,
                "block_sparse_dw": n_proj * k, "block_sparse_fwd_merge": 2 * per("bs_fwd"),
                "block_sparse_dx_merge": per("bs_dx"), "block_sparse_dw_merge": per("bs_dw"),
                "flash_fwd": 2 * n_attn * k, "flash_dq": n_attn * k, "flash_dkv": n_attn * k}

    tokens = (TRAIN_BATCH * TRAIN_SEQ // mb, TRAIN_BATCH * TRAIN_SEQ)
    blk = cfg.sparse.block_shape
    log, seen = [], {"counts": None, "t": None, "ev": None, "blocks": None, "prof": None,
                     "merges": merges}

    def blocks_of(masks):
        return {n: block_mask_of(m, blk).cpu() for n, m in tree_paths(masks).items()}

    def on_step(step, is_update, state, m):
        torch.cuda.synchronize()
        t, ev = time.perf_counter(), torch.cuda.Event(enable_timing=True)
        ev.record()
        counts = read()
        prev = seen["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if seen["t"] is not None:
            rec["wall_s"] = t - seen["t"]
            rec["device_span_ms"] = seen["ev"].elapsed_time(ev)
        # the step ran on the pack it left unless it updated the topology
        count = lambda: {e: tuple(bs_merges(torch, cfg, state, n, e) for n in tokens)
                         for e in BS_ENTRIES}
        now = seen["merges"] if is_update else count()
        if rec["launches"] != expect(is_update, now):
            raise AssertionError(f"train step {step}: launches {rec['launches']}, "
                                 f"expected {expect(is_update, now)}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"train step {step}: loss {rec['loss']}")
        seen["merges"] = count()
        if step == 1:
            seen["blocks"] = blocks_of(state["masks"])
        if step == 4:  # step 5, a plain step after the update, is profiled
            seen["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            seen["prof"].__enter__()
        elif step == 5:
            seen["prof"].__exit__(None, None, None)
        print("train:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        seen.update(counts=counts, t=time.perf_counter(), ev=torch.cuda.Event(enable_timing=True))
        seen["ev"].record()

    for _, mod, a in counters:
        setattr(mod, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = train_loop(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          workdir=str(ROOT / "chiprun_out" / "train"), device="cuda",
                          on_step=on_step, log_every=TRAIN_STEPS, ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # after the drop/grow: counts kept, topology moved, pack fresh and valid,
    # superset around the mask
    after = blocks_of(state["masks"])
    bwd = blocks_of(state["bwd_masks"])
    moved = 0
    for n, b0 in seen["blocks"].items():
        if int(after[n].sum()) != int(b0.sum()):
            raise AssertionError(f"{n}: {int(b0.sum())} active blocks before the "
                                 f"update, {int(after[n].sum())} after")
        if (after[n] & ~bwd[n]).any():
            raise AssertionError(f"{n}: the superset does not contain the mask")
        moved += int((after[n] & ~b0).sum())
    if moved == 0:
        raise AssertionError("the drop/grow moved no block")
    validate_pack(state["pack"], where="chip_smoke")
    stale = int(pack_mismatch(state["masks"], state["pack"], blk, bwd_masks=state["bwd_masks"]))
    if stale:
        raise AssertionError(f"pack stale after the update: {stale} blocks")

    steady = [r for r in log if "wall_s" in r and not r["update"] and r["step"] != 5]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    stats = {"steps": TRAIN_STEPS, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
             "total_s": total_s, "peak_mem_gib": peak_gib, "blocks_moved": moved,
             "mean_train_step_wall_s": wall,
             "mean_train_step_device_span_ms": sum(r["device_span_ms"] for r in steady) / len(steady),
             "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
             "update_step_wall_s": [r["wall_s"] for r in log if r["update"] and "wall_s" in r],
             "losses": [r["loss"] for r in log], "launches_per_step": [r["launches"] for r in log]}
    # device busy time: the kernels' (and copies') own device time; an
    # operator's row repeats the device time of the kernels it launched
    from torch.autograd import DeviceType

    prof = [e for e in seen["prof"].key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total
    busy_ms = sum(dev_us(e) for e in prof) / 1e3
    profiled = next(r for r in log if r["step"] == 5)
    stats["profiled_step_wall_s"] = profiled["wall_s"]
    stats["profiled_step_device_busy_ms"] = busy_ms or None
    top = sorted(prof, key=dev_us, reverse=True)[:25]
    stats["profiled_step_top"] = [(e.key, dev_us(e) / 1e3, e.count) for e in top]
    # the flash kernels' share (K9 forward, K10 + K11 backward and the merge
    # of their split walks)
    flash_ms = {n: sum(dev_us(e) for e in prof if f"{n}_kernel" in e.key) / 1e3
                for n in ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_merge")}
    stats["profiled_step_flash_ms"] = flash_ms
    stats["profiled_step_flash_share"] = sum(flash_ms.values()) / busy_ms if busy_ms else None
    bs_ms = block_sparse_ms(prof)
    stats["profiled_step_block_sparse_ms"] = bs_ms
    stats["profiled_step_k2_share"] = bs_ms["block_sparse_dx"] / busy_ms if busy_ms else None
    (ROOT / "chiprun_out" / "train_profile.txt").write_text(
        seen["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    print(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{total_s:.1f} s; train step {wall:.3f} s wall = {stats['tok_per_s']:.0f} tok/s; "
          f"device busy {busy_ms:.1f} ms of the profiled step's "
          f"{profiled['wall_s']:.3f} s (flash K9-K11 {sum(flash_ms.values()):.1f} ms "
          f"{flash_ms}; block-sparse {bs_ms}, K2 "
          f"{stats['profiled_step_k2_share'] or 0:.1%} of the busy time); peak {peak_gib:.1f} GiB; "
          f"{moved} blocks moved by the drop/grow; launches {launches}")
    return stats, launches


# ---------------------------------------------------------------------------
# masked mode: elementwise masks through K13, K14, K15 and the fused K19
# ---------------------------------------------------------------------------

MASKED_TRAIN_STEPS, MASKED_BATCH, FUSED_STEPS = 6, 2, 2
MASKED_PROJ = (("attn.wq", "attn", "wq"), ("attn.wk", "attn", "wk"),
               ("mlp.wi", "mlp", "wi"), ("mlp.wo", "mlp", "wo"))


def masked_config(**sparse_kw):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel="masked",
                           attn_kernel="flash_tight")
    return dataclasses.replace(cfg, microbatches=1, sparse=dataclasses.replace(
        cfg.sparse, method="rigl", delta_t=DELTA_T, **sparse_kw))


def kernel_case(torch, timer, kernel, label, run, plain, library, check, n_bytes,
                flops, dtype):
    """One kernel case: the check against the plain version, then the
    kernel, the plain version and the library call (None: no one PyTorch
    call computes the function) timed beside the bound."""
    err, ratio, tol = check()
    b_ms, by = bound_ms(n_bytes, flops, peak_of(torch, dtype))
    case = {"case": label, "max_abs_err": err, "err_over_tol": ratio, "mean_tol": tol,
            "ms": timer(run), "plain_ms": timer(plain, reps=3),
            "library_ms": None if library is None else timer(library),
            "bound_ms": b_ms, "bound_by": by, "bytes": n_bytes, "flops": flops}
    print(kernel, json.dumps(case))
    return case


def masked_cases(torch, timer, mm, params, masks, proj=MASKED_PROJ, bn=128, fused=True):
    """K13 at a decode step's 4 rows (-> 16) and at 2048 rows, K14, K15 and
    K19 (sr off and on, bf16 momentum as the fused path keeps it) at the
    training microbatch's 2048 rows, on layer 0's own weights and ERK
    masks: attention bf16 (wq 2560x2560, wk 2560x640), MLP f32 (wi
    2560x6912, wo 6912x2560); K15 and K19 on a superset B = A plus 10% of
    the weights.  Each output element by element within its bound
    (``mm.matmul_error_bound``, ``mm.fused_error_bound``); K19 with sr bit
    for bit the plain ``sr_to_bf16`` of the kernel's own f32 m_new.  K13
    and K14 also under every candidate plan (``fwd_sweep``: each plan
    within the bound, then timed), the f32 cases at 2048 rows against a
    float64 product (``f64_fidelity``), and the split merge of each split
    pick (``merge_case``); K15 likewise (its plan on rows K, contraction M,
    columns N; its merge masks the ordered sum), and K19 with sr off (its
    plan on the fused kernel's slots; its merge applies the momentum
    epilogue to the ordered sum; the float64 reference the epilogue on a
    float64 product).  Bytes count every input once (w and its 1-byte mask
    included) and every output once; operations count the active weights'
    products (2 per multiply-add).  Library: cuBLAS on the pre-masked
    weight (TF32 off); K19's yardstick K15 then the SGD update.  ``proj``:
    the (label, subtree, name) projections of layer 0; ``bn``: the column
    and contraction tile cap the path passes (64 for hymba); ``fused``
    adds K19."""
    from repro_torch.kernels.ops import _row_tile

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"K13": [], "K14": [], "K15": [], "K19": [], "merge": [], "dx_merge": [],
           "dw_merge": [], "dw_fused_merge": []}
    for label, sub, name in proj:
        w = params["layers"][0][sub][name]["w"]
        m = masks["layers"][0][sub][name]["w"]
        K, N = w.shape
        dt, es = w.dtype, w.element_size()
        b = m | (torch.rand(K, N, generator=gen, device="cuda") < 0.1)
        nnz, bnnz = int(m.sum()), int(b.sum())
        wm = w * m
        awm = wm.float().abs()
        tag = f"layer0 {label} {str(dt)[6:]} K={K} N={N} density={nnz / (K * N):.3f}"

        within_ = lambda got, want, bound: within_tol(torch, tag, got, want, bound)

        for M in (4, 2048):
            x = torch.randn(M, K, device="cuda").to(dt)
            bm, Mp = _row_tile(M, 128)
            xp = torch.nn.functional.pad(x, (0, 0, 0, Mp - M))
            case = kernel_case(
                torch, timer, "K13", f"{tag} M={M}->{Mp}",
                lambda: mm.masked_matmul(xp, w, m, bm=bm, bn=bn),
                lambda: mm.masked_matmul_plain(xp, w, m), lambda: x @ wm,
                lambda: within_(mm.masked_matmul(xp, w, m, bm=bm, bn=bn),
                                mm.masked_matmul_plain(xp, w, m),
                                mm.matmul_error_bound(mm.masked_matmul_plain(xp, w, m),
                                                      xp.float().abs() @ awm, K)),
                es * (M * K + M * N) + (es + 1) * K * N, 2.0 * M * nnz, dt)
            want = mm.masked_matmul_plain(xp, w, m)
            bound = mm.matmul_error_bound(want, xp.float().abs() @ awm, K)
            case.update(fwd_sweep(torch, timer, mm, lambda plan: mm.masked_matmul(
                xp, w, m, bm=bm, bn=bn, plan=plan), Mp, K, N, 1, dt, case,
                check=lambda got: within_(got, want, bound), bn_limit=bn))
            del want, bound
            if dt == torch.float32 and M == 2048:
                case["f64_rms_over_plain"] = f64_fidelity(
                    torch, f"K13 {tag}", lambda: mm.masked_matmul(xp, w, m, bm=128, bn=bn),
                    lambda: mm.masked_matmul_plain(xp, w, m), lambda: xp.double() @ wm.double())
            print("K13 plans", json.dumps(case))
            out["K13"].append(case)
            if case["plan"][2] > 1:
                out["merge"].append(merge_case(torch, timer, mm, case["plan"][2], 1, Mp, N,
                                               dt, f"{tag} M={M}->{Mp}"))
        M = 2048
        x = torch.randn(M, K, device="cuda").to(dt)
        g = torch.randn(M, N, device="cuda").to(dt)
        case = kernel_case(
            torch, timer, "K14", f"{tag} M={M}",
            lambda: mm.masked_dx(g, w, m, bm=128, bk=bn),
            lambda: mm.masked_dx_plain(g, w, m), lambda: g @ wm.T,
            lambda: within_(mm.masked_dx(g, w, m, bm=128, bk=bn), mm.masked_dx_plain(g, w, m),
                            mm.matmul_error_bound(mm.masked_dx_plain(g, w, m),
                                                  g.float().abs() @ awm.T, N)),
            es * (M * N + M * K) + (es + 1) * K * N, 2.0 * M * nnz, dt)
        want = mm.masked_dx_plain(g, w, m)
        bound = mm.matmul_error_bound(want, g.float().abs() @ awm.T, N)
        case.update(fwd_sweep(torch, timer, mm, lambda plan: mm.masked_dx(
            g, w, m, bm=128, bk=bn, plan=plan), M, N, K, 1, dt, case, entry="dx",
            check=lambda got: within_(got, want, bound), bn_limit=bn))
        del want, bound
        if dt == torch.float32:
            case["f64_rms_over_plain"] = f64_fidelity(
                torch, f"K14 {tag}", lambda: mm.masked_dx(g, w, m, bm=128, bk=bn),
                lambda: mm.masked_dx_plain(g, w, m), lambda: g.double() @ wm.double().T)
        print("K14 plans", json.dumps(case))
        out["K14"].append(case)
        if case["plan"][2] > 1:
            out["dx_merge"].append(merge_case(torch, timer, mm, case["plan"][2], 1, M, K, dt,
                                              f"{tag} M={M}", entry="dx"))
        absp = x.float().abs().T @ g.float().abs()
        dw_tag = f"{tag} M={M} superset density={bnnz / (K * N):.3f}"
        case = kernel_case(
            torch, timer, "K15", dw_tag,
            lambda: mm.masked_dw(x, g, b, bn=bn, bk=bn),
            lambda: mm.masked_dw_plain(x, g, b), lambda: (x.T @ g) * b,
            lambda: within_(mm.masked_dw(x, g, b, bn=bn, bk=bn), mm.masked_dw_plain(x, g, b),
                            mm.matmul_error_bound(mm.masked_dw_plain(x, g, b), absp * b, M)),
            es * (M * K + M * N + K * N) + K * N, 2.0 * M * bnnz, dt)
        want = mm.masked_dw_plain(x, g, b)
        bound = mm.matmul_error_bound(want, absp * b, M)
        case.update(fwd_sweep(torch, timer, mm, lambda plan: mm.masked_dw(
            x, g, b, bn=bn, bk=bn, plan=plan), K, M, N, 1, dt, case, entry="dw",
            check=lambda got: within_(got, want, bound), bn_limit=bn))
        case["dense_tflop_s"] = 2.0 * M * K * N / case["ms"] / 1e9
        del want, bound
        if dt == torch.float32:
            case["f64_rms_over_plain"] = f64_fidelity(
                torch, f"K15 {tag}", lambda: mm.masked_dw(x, g, b, bn=bn, bk=bn),
                lambda: mm.masked_dw_plain(x, g, b),
                lambda: (x.double().T @ g.double()) * b)
        print("K15 plans", json.dumps(case))
        out["K15"].append(case)
        if case["plan"][2] > 1:
            out["dw_merge"].append(merge_case(torch, timer, mm, case["plan"][2], 1, K, N, dt,
                                              dw_tag, entry="dw", mask=b))
        if not fused:
            continue
        mom = (0.01 * torch.randn(K, N, device="cuda")).to(torch.bfloat16) * b
        acc = x.float().T @ g.float()
        kw = dict(mu=0.9, wd=1e-4, bn=bn, bk=bn)
        seed = 0x9E3779B9
        unfused = lambda: (0.9 * mom.float() + mm.masked_dw(x, g, b, bn=bn, bk=bn).float()
                           + 1e-4 * w.float()).to(dt)
        for sr in (False, True):
            fused = lambda: mm.masked_dw_fused(x, g, b, w, mom, seed, sr=sr, **kw)
            plain = lambda: mm.masked_dw_fused_plain(x, g, b, w, mom, seed, mu=0.9, wd=1e-4,
                                                     sr=sr)

            def check():
                if not sr:
                    want = plain()
                    return within_(fused(), want, mm.fused_error_bound(
                        want, absp, M, 0.9, 1e-4, mom, w, acc, b))
                raw = mm.masked_dw_fused(x, g, b, w, mom, seed, sr=False,
                                         out_dtype=torch.float32, **kw)
                got = fused()
                want = mm.sr_to_bf16(raw, seed, mm._gid(K, N, "cuda")).to(dt)
                if not torch.equal(got.float(), want.float()) or \
                        not torch.equal(got.float(), got.to(torch.bfloat16).float()):
                    raise AssertionError(f"K19 {tag}: sr differs from sr_to_bf16 of "
                                         "the kernel's own m_new, or off the bf16 grid")
                return (got.float() - want.float()).abs().max().item(), 0.0, 0.0

            case = fused_case(torch, timer, "K19", f"{tag} M={M} sr={sr} mom bf16", fused,
                              plain, unfused, check,
                              es * (M * K + M * N) + K * N * (1 + 2 * es + 2),
                              2.0 * M * bnnz, dt)
            if not sr:
                out["dw_fused_merge"] += fused_sweep(
                    torch, timer, mm, case, x, g, b, w, mom, seed, acc, absp, dt, "K19 " + tag)
            out["K19"].append(case)
    return out


def fwd_sweep(torch, timer, mm, run, Mp, L, cols, G, dt, case, entry="fwd", check=None,
              bn_limit=128, live=None, bk=None, kinds=(), check_plan=None):
    """The GEMM core's plan at one case of ``entry`` ("fwd": K13/K16, L = K
    and cols = N; "dx": K14/K17, L = N and cols = K; "dw": K15/K18, Mp = K,
    L = M and cols = N; the block-sparse kernels, whose plans are the
    block-sparse module's own, on ``live`` blocks: "bs_fwd": K1/K4 as "fwd"
    with blocks of ``bk`` (the contraction's) x ``bn_limit`` (the
    columns'), "bs_dx": K2/K5 as "dx" with blocks of ``bn_limit`` (dx's
    columns, w's rows) x ``bk`` (the contraction's), "bs_dw": K3/K6 as "dw"
    with blocks of ``bn_limit`` columns, or with ``kinds`` = (mom dtype,
    output dtype) K7/K8, on the fused kernel's own slots) and every
    candidate plan (the module's candidates on the card's slots for that
    kernel) timed with the plan forced, each
    first held to ``check`` (raises) where one is given, or to
    ``check_plan(got, plan)``, and to the same
    bits from a second launch; raises on a spill in the pick's launch: the pick, whether
    it was the fastest, the launch of the pick's tile (CTAs an SM,
    registers, shared and spill bytes), and the case's achieved rate
    (TFLOP/s of the products its bound counts, TB/s of its bytes) and share
    of the bound."""
    from repro_torch.kernels import block_sparse_matmul as bsm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.cuda.current_device()
    if entry == "bs_fwd":  # K1/K4: the id list of L / bk blocks in shared memory
        info_of = lambda tm, tn: bsm.fwd_launch_info(dt, tm, tn, L // bk)
        slots = sms * info_of(*mm.fwd_tile(Mp, bn_limit))["ctas_per_sm"]
        pick = bsm._fwd_plan_for(Mp, L, cols, G, dt, bk, bn_limit, live, dev)
        cands = bsm.fwd_candidates(Mp, L, cols, G, dt, slots, bk=bk, bn=bn_limit, live=live)
    elif entry == "bs_dx":  # K2/K5 (w (cols, L)): likewise, a list of L / bk blocks
        info_of = lambda tm, tn: bsm.dx_launch_info(dt, tm, tn, L // bk)
        slots = sms * info_of(*mm.fwd_tile(Mp, bn_limit))["ctas_per_sm"]
        pick = bsm._dx_plan_for(Mp, cols, L, G, dt, bn_limit, bk, live, dev)
        cands = bsm.dx_candidates(Mp, cols, L, G, dt, slots, bk=bn_limit, bn=bk, live=live)
    elif entry == "bs_dw":  # K3/K6 (K7/K8 with kinds): rows Mp = K, contraction L = M
        info_of = lambda tm, tn: bsm.dw_launch_info(dt, tm, tn, *kinds)
        slots = sms * info_of(*bsm.dw_tile(bn_limit))["ctas_per_sm"]
        pick = bsm._dw_plan_for(L, Mp, cols, G, dt, bn_limit, live, dev, *kinds)
        cands = bsm.dw_candidates(L, Mp, cols, G, dt, slots, bn=bn_limit, live=live)
    else:
        info_of = lambda tm, tn: mm.fwd_launch_info(dt, tm, tn, entry)
        slots = sms * info_of(*mm.fwd_tile(Mp, bn_limit, entry))["ctas_per_sm"]
        pick = mm._fwd_plan_for(Mp, L, cols, G, dt, bn_limit, dev, entry)
        cands = mm.fwd_candidates(Mp, L, cols, G, dt, slots, bn_limit=bn_limit, entry=entry)
    info = info_of(*pick[:2])
    if info["spill_bytes"]:
        raise AssertionError(f"{entry} tile {pick[:2]} {dt}: {info['spill_bytes']} spill bytes")
    plans = {}
    for p in cands:
        if check is not None or check_plan is not None:
            got = run(p)
            check(got) if check_plan is None else check_plan(got, p)
            if not torch.equal(got, run(p)):
                raise AssertionError(f"{entry} plan {p}: two launches differ")
            del got
        plans[str(p)] = timer(lambda: run(p), reps=5)
    return {"plan": list(pick), "slots": slots, "launch": info, "plans_ms": plans,
            "plan_is_fastest": plans[str(pick)] == min(plans.values()),
            "plan_over_fastest": plans[str(pick)] / min(plans.values()),
            "tflop_s": case["flops"] / case["ms"] / 1e9,
            "tb_s": case["bytes"] / case["ms"] / 1e9,
            "share_of_bound": case["bound_ms"] / case["ms"]}


def f64_fidelity(torch, tag, run, plain, ref):
    """RMS error of a GEMM-core kernel (``run``) against a float64 product
    (``ref``) over the plain f32 version's (3xTF32 keeps f32's digits: at
    most 8; one-pass TF32 ~1000)."""
    ref = ref()
    rms = lambda t: float(((t.double() - ref) ** 2).mean().sqrt())
    got, base = rms(run()), rms(plain())
    print(f"{tag}: RMS error against float64 {got:.4g}, plain f32 {base:.4g} "
          f"({got / base:.3f}x)")
    if not got <= 8 * base:
        raise AssertionError(f"{tag}: RMS error {got} over 8x the plain version's {base}")
    return got / base


def merge_case(torch, timer, mm, n_split, G, Mp, N, dt, tag, entry="fwd", mask=None,
               fused=None):
    """The split merge (sum of n_split f32 partials in order, one rounding)
    at a split pick's shape (G, Mp rows, N columns), after ``entry``'s
    kernel (``mm.fwd_merge``, ``mm.dx_merge``, ``mm.dw_merge``, which
    multiplies the sum by the wgrad's ``mask``, ``mm.dw_fused_merge``
    after K19/K20 ("dw_fused"), which applies the momentum epilogue with
    ``fused`` = (w, mom, seed, mu, wd, sr) and the wgrad ``mask``, after
    K1/K4 ("bs_fwd") ``bs_fwd_merge``, after K2/K5 ("bs_dx")
    ``bs_dx_merge``): bit for bit its plain version, timed beside its byte
    bound and torch.sum over the split axis (then the mask, or the
    epilogue without sr)."""
    from repro_torch.kernels import block_sparse_matmul as bsm

    part = torch.randn(n_split, G, Mp, N, device="cuda")
    out = torch.empty(G, Mp, N, dtype=dt, device="cuda")
    plain = lambda: mm.fwd_merge_plain(part, dt, mask)
    extra = 0
    if entry == "dw_fused":
        mask = mask.reshape(G, Mp, N)
        w, mom, seed, mu, wd, sr = fused
        w, mom = w.reshape(G, Mp, N), mom.reshape(G, Mp, N)
        merge = lambda p, o: mm.dw_fused_merge(p, mask, w, mom, o, seed, mu=mu, wd=wd, sr=sr)
        plain = lambda: mm.masked_dw_fused_merge_plain(part, mask, w, mom, seed, mu=mu, wd=wd,
                                                       sr=sr, out_dtype=dt)
        library = lambda: ((mu * mom.float() + part.sum(0) + wd * w.float()) * mask).to(dt)
        extra = w.numel() * (w.element_size() + mom.element_size())
    elif entry == "dw":
        mask = mask.reshape(G, Mp, N)
        merge = lambda p, o: mm.dw_merge(p, mask, o)
        library = lambda: (part.sum(0) * mask).to(dt)
    else:
        merge = {"fwd": mm.fwd_merge, "dx": mm.dx_merge, "bs_fwd": bsm.bs_fwd_merge,
                 "bs_dx": bsm.bs_dx_merge}[entry]
        library = lambda: part.sum(0).to(dt)

    def check():
        got, want = merge(part, out), plain()
        if not torch.equal(got.float(), want.float()):
            raise AssertionError(f"{entry} merge {tag}: differs from the ordered plain sum")
        return 0.0, 0.0, 0.0

    label = {"fwd": "merge", "dx": "dx merge", "dw": "dw merge", "dw_fused": "dw fused merge",
             "bs_fwd": "bs fwd merge", "bs_dx": "bs dx merge"}[entry]
    n_bytes = 4 * part.numel() + out.element_size() * out.numel() + (
        0 if mask is None else mask.numel()) + extra
    return kernel_case(torch, timer, label, f"{tag} n_split={n_split}",
                       lambda: merge(part, out), plain, library, check, n_bytes, 0.0, dt)


def planned_merges(torch, mm, cfg, layer, Mp, entry="fwd"):
    """Split merges of one layer's 7 K13 (``entry`` "fwd"), K14 ("dx"), K15
    ("dw") or K19 ("dw_fused") launches at Mp padded rows: each
    projection's plan (attention in the compute dtype, the MLP or shared
    MLP in f32, as the model calls them) splits or not."""
    from repro_torch.models.layers import compute_dtype

    mlp = layer["mlp"] if "mlp" in layer else layer["moe"]["shared"]
    shapes = ([(layer["attn"][n]["w"].shape, compute_dtype(cfg)) for n in ("wq", "wk", "wv", "wo")]
              + [(mlp[n]["w"].shape, torch.float32) for n in ("wi", "wg", "wo")])
    dev = torch.cuda.current_device()
    _, bn, bk = cfg.sparse.kernel_block
    if entry == "fwd":
        return sum(mm._fwd_plan_for(Mp, K, N, 1, dt, bn, dev)[2] > 1 for (K, N), dt in shapes)
    if entry in mm.WGRADS:
        return sum(mm._fwd_plan_for(K, Mp, N, 1, dt, bn, dev, entry)[2] > 1
                   for (K, N), dt in shapes)
    return sum(mm._fwd_plan_for(Mp, N, K, 1, dt, bk, dev, "dx")[2] > 1 for (K, N), dt in shapes)


def bank_merges(torch, mm, cfg, layer, tokens, entry="dx"):
    """Split merges of one MoE layer's 3 K17 (``entry`` "dx"), K18 ("dw")
    or K20 ("dw_fused") launches (wi, wg, wo) on a microbatch of ``tokens``
    tokens: each bank's plan at the capacity's padded rows."""
    from repro_torch.kernels.ops import _row_tile
    from repro_torch.models.moe import capacity

    _, Mp = _row_tile(capacity(tokens, cfg), cfg.sparse.kernel_block[0])
    dev = torch.cuda.current_device()
    _, bn, bk = cfg.sparse.kernel_block
    banks = [(w.shape, w.dtype) for w in (layer["moe"][b]["w"] for b in MOE_BANKS)]
    if entry in mm.WGRADS:
        return sum(mm._fwd_plan_for(K, Mp, N, G, dt, bn, dev, entry)[2] > 1
                   for (G, K, N), dt in banks)
    return sum(mm._fwd_plan_for(Mp, N, K, G, dt, bk, dev, "dx")[2] > 1 for (G, K, N), dt in banks)


def masked_serve(torch, timer, mm, fa):
    """Serve full-size h2o-danube-1.8b under kernel='masked' (ERK 0.8
    elementwise masks, flash_tight): the block-sparse phase's 8 requests;
    every request DONE; kernel-path logits against the plain dense path;
    exactly 168 K13 launches in one decode step; the decode step's device
    time (CUDA graph) and the share of its 168 K13 launches; then the K13,
    K14, K15 and K19 cases on layer 0's served weights and masks."""
    from repro_torch.launch.serve import init_serving_state, staggered_requests
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    cfg = masked_config()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    if pack is not None:
        raise AssertionError("masked serving carries no pack")
    engine = ServeEngine(cfg, params, capacity=4, max_len=2048, masks=masks)
    del params
    for r in staggered_requests(cfg, 2, prompt_lens=(100,), gen_lens=(2,), seed=1):
        engine.submit(r)
    engine.run()
    reqs = staggered_requests(cfg, 8, prompt_lens=(100, 300, 1000), gen_lens=(32,), seed=0)
    engine = ServeEngine(cfg, engine.params, capacity=4, max_len=2048, masks=masks)
    for r in reqs:
        engine.submit(r)
    mm.launches = mm.fwd_merge_launches = 0
    fa.launches = 0
    stats = engine.run()
    launches = {"masked_fwd": mm.launches, "masked_fwd_merge": mm.fwd_merge_launches,
                "flash_fwd": fa.launches}
    print("masked serve: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "quarantined", "failed",
        "wall_s", "tok_per_s", "prefill_s", "decode_step_s")}))
    print(f"masked serve: prefill {1e3 * stats['prefill_s'] / stats['prefills']:.2f} "
          f"ms/request, decode {1e3 * stats['decode_step_s']:.2f} ms/step "
          f"(capacity 4), {stats['tok_per_s']:.2f} tok/s end to end; launches {launches}")
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != 32:
            raise AssertionError(f"masked request {r.rid}: {r.status}")
    if stats["quarantined"] or stats["failed"] or not all(launches.values()):
        raise AssertionError(f"masked serve: {stats}, launches {launches}")
    merges = cfg.n_layers * planned_merges(torch, mm, cfg, engine.params["layers"][0], 16)

    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))
    toks = torch.from_numpy(reqs[0].tokens).long().cuda()[None]
    res = {}
    for name, c in (("kernel", cfg), ("dense", dense)):
        logits, caches = lm_prefill(engine.params, c, {"tokens": toks}, 128, masks=masks)
        nxt = logits[:, -1].argmax(-1)[:, None]
        n0, g0 = mm.launches, mm.fwd_merge_launches
        step, _ = lm_decode(engine.params, c, caches, nxt, toks.shape[1], masks=masks)
        if name == "kernel":
            stats["k13_launches_per_decode_step"] = mm.launches - n0
            stats["k13_merges_per_decode_step"] = mm.fwd_merge_launches - g0
        V = cfg.vocab_size
        res[name] = (logits.float()[..., :V], step.float()[..., :V])
    if (stats["k13_launches_per_decode_step"], stats["k13_merges_per_decode_step"]) != \
            (7 * cfg.n_layers, merges):
        raise AssertionError(f"decode step launched K13 "
                             f"{stats['k13_launches_per_decode_step']} times and its merge "
                             f"{stats['k13_merges_per_decode_step']} (plans: {merges})")
    print(f"masked serve: one decode step: {stats['k13_launches_per_decode_step']} K13 "
          f"launches, {stats['k13_merges_per_decode_step']} split merges")
    for i, what in enumerate(("prefill", "decode")):
        a, b = res["kernel"][i], res["dense"][i]
        if not bool(torch.isfinite(a).all()) or a.shape != (1, 1, cfg.vocab_size):
            raise AssertionError(f"masked {what} logits not finite or of the wrong shape")
        err = (a - b).abs().max().item()
        # the bf16 tolerance of the block-sparse path: 5e-3 of the largest logit
        tol = 5e-3 * b.abs().max().item()
        print(f"masked serve: {what} logits, kernel path vs dense path: max err "
              f"{err:.4g} (tol {tol:.4g}); top-1 {int(a.argmax())} vs {int(b.argmax())}")
        stats[f"{what}_logit_err"], stats[f"{what}_logit_tol"] = err, tol
        if err > tol:
            raise AssertionError(f"masked {what} logits differ from the dense path")
    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode)
    calls = []
    for layer in range(cfg.n_layers):
        for sub in ("attn", "mlp"):
            for name, leaf in engine.params["layers"][layer][sub].items():
                w = leaf["w"]
                calls.append((torch.randn(16, w.shape[0], device="cuda").to(w.dtype), w,
                              engine.masks["layers"][layer][sub][name]["w"]))
    run = lambda: [mm.masked_matmul(x, w, m, bm=16, bn=128) for x, w, m in calls]
    stats["k13_decode_step_ms"] = graph_ms(torch, run)
    print(f"masked serve: K13 in one decode step: {len(calls)} launches, "
          f"{stats['k13_decode_step_ms']:.2f} ms device time (CUDA-graph replay), "
          f"{stats['k13_decode_step_ms'] / stats['decode_step_device_ms']:.1%} of the step")
    cases = masked_cases(torch, timer, mm, engine.params, masks)
    return stats, launches, cases


def masked_train(torch, mm, fa, bsm):
    """Train full-size h2o-danube-1.8b under kernel='masked' with RigL on
    elementwise masks and the Top-KAST superset (Δ = 10%), Adam,
    flash_tight, batch 2 x 1024 in one microbatch: first the step-0 loss
    and layer-0 gradients against the plain dense path, then ``train_loop``
    for 6 steps (a drop/grow at step 2) with the exact launches of every
    step, and after the update per-layer counts kept, B ⊇ A and the
    carrier holding the fresh superset."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.core.pack import pack_entries, validate_pack
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    cfg = masked_config()
    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    dense_check = train_dense_check(torch, cfg, state)
    layer0 = state["params"]["layers"][0]
    merges = planned_merges(torch, mm, cfg, layer0, MASKED_BATCH * TRAIN_SEQ)
    dx_merges = planned_merges(torch, mm, cfg, layer0, MASKED_BATCH * TRAIN_SEQ, "dx")
    dw_merges = planned_merges(torch, mm, cfg, layer0, MASKED_BATCH * TRAIN_SEQ, "dw")
    del state, layer0
    torch.cuda.empty_cache()

    counters = (("masked_fwd", mm, "launches"), ("masked_fwd_merge", mm, "fwd_merge_launches"),
                ("masked_dx", mm, "dx_launches"), ("masked_dx_merge", mm, "dx_merge_launches"),
                ("masked_dw", mm, "dw_launches"), ("masked_dw_merge", mm, "dw_merge_launches"),
                ("masked_dw_fused", mm, "fused_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"), ("block_sparse_fwd", bsm, "launches"))
    read = lambda: {n: getattr(mod, a) for n, mod, a in counters}
    n_proj, n_attn = 7 * cfg.n_layers, cfg.n_layers
    # remat reruns each block's forward in the backward; one microbatch, so
    # the update step's full-batch gradient launches the same
    expect = {"masked_fwd": 2 * n_proj, "masked_fwd_merge": 2 * merges * cfg.n_layers,
              "masked_dx": n_proj, "masked_dx_merge": dx_merges * cfg.n_layers,
              "masked_dw": n_proj, "masked_dw_merge": dw_merges * cfg.n_layers,
              "masked_dw_fused": 0, "flash_fwd": 2 * n_attn, "flash_dq": n_attn,
              "flash_dkv": n_attn, "block_sparse_fwd": 0}
    log, seen = [], {"counts": None, "t": None, "masks": None, "prof": None}

    def on_step(step, is_update, state, m):
        torch.cuda.synchronize()
        t, counts = time.perf_counter(), read()
        prev = seen["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if seen["t"] is not None:
            rec["wall_s"] = t - seen["t"]
        if rec["launches"] != expect or not math.isfinite(rec["loss"]):
            raise AssertionError(f"masked train step {step}: {rec}, expected {expect}")
        if step == 1:
            seen["masks"] = {n: int(v.sum()) for n, v in tree_paths(state["masks"]).items()}
        if step == MASKED_TRAIN_STEPS - 1:  # the last step, a plain one, is profiled
            seen["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            seen["prof"].__enter__()
        elif step == MASKED_TRAIN_STEPS:
            seen["prof"].__exit__(None, None, None)
        print("masked train:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        seen.update(counts=read(), t=time.perf_counter())

    for _, mod, a in counters:
        setattr(mod, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = train_loop(cfg, steps=MASKED_TRAIN_STEPS, batch=MASKED_BATCH, seq=TRAIN_SEQ,
                          workdir=str(ROOT / "chiprun_out" / "masked_train"), device="cuda",
                          on_step=on_step, log_every=MASKED_TRAIN_STEPS,
                          ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    masks, bwd = tree_paths(state["masks"]), tree_paths(state["bwd_masks"])
    for n, m in masks.items():
        if int(m.sum()) != seen["masks"][n]:
            raise AssertionError(f"{n}: {seen['masks'][n]} weights before the update, "
                                 f"{int(m.sum())} after")
        if (m & ~bwd[n]).any():
            raise AssertionError(f"{n}: the superset does not contain the mask")
    carried = dict(pack_entries(state["pack"]))
    if sorted(carried) != sorted(masks) or any(carried[n]["bwd_mask"] is not bwd[n]
                                               for n in masks):
        raise AssertionError("the carrier does not hold the refreshed superset")
    validate_pack(state["pack"], where="chip_smoke masked")
    del state
    torch.cuda.empty_cache()
    steady = [r for r in log if "wall_s" in r and not r["update"]
              and r["step"] != MASKED_TRAIN_STEPS]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    from torch.autograd import DeviceType

    prof = [e for e in seen["prof"].key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    top = sorted(prof, key=dev_ms, reverse=True)[:25]
    (ROOT / "chiprun_out" / "masked_train_profile.txt").write_text(
        seen["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    stats = {"steps": MASKED_TRAIN_STEPS, "tokens_per_step": MASKED_BATCH * TRAIN_SEQ,
             "profiled_step_wall_s": log[-1]["wall_s"],
             "profiled_step_device_busy_ms": sum(dev_ms(e) for e in prof) or None,
             "profiled_step_top": [(e.key, dev_ms(e), e.count) for e in top],
             "total_s": total_s, "peak_mem_gib": peak_gib, "mean_train_step_wall_s": wall,
             "steady_steps": [r["step"] for r in steady],
             "tok_per_s": MASKED_BATCH * TRAIN_SEQ / wall,
             "update_step_wall_s": [r["wall_s"] for r in log if r["update"] and "wall_s" in r],
             "losses": [r["loss"] for r in log], "step0_vs_dense": dense_check}
    print(f"masked train: {MASKED_TRAIN_STEPS} steps of {MASKED_BATCH} x {TRAIN_SEQ} tokens "
          f"in {total_s:.1f} s; train step {wall:.3f} s wall = {stats['tok_per_s']:.0f} "
          f"tok/s; device busy {stats['profiled_step_device_busy_ms'] or 0:.1f} ms of the "
          f"profiled step's {log[-1]['wall_s']:.3f} s; peak {peak_gib:.1f} GiB; "
          f"launches {launches}")
    return stats, launches


FUSED_MU, FUSED_WD, FUSED_SEED = 0.9, 1e-4, 0x9E3779B9


def fused_opt():
    """The fused path's optimizer and LR: SGD momentum 0.9, wd 1e-4, bf16
    state (in-kernel stochastic rounding), a constant 1e-3."""
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig

    return (OptConfig(kind="sgd", momentum=FUSED_MU, weight_decay=FUSED_WD,
                      state_dtype="bfloat16"),
            LRSchedule(kind="constant", base_lr=1e-3, warmup_steps=0))


def fused_steps(torch, cfg, state, counters, want, label, pin_routing=False,
                unfused_merges=None):
    """``FUSED_STEPS`` train steps of ``cfg`` with ``sparse.fused_epilogue``
    on ``state``, each beside the unfused step on a copy of the same weights
    (the steps update in place), in alternating order, batch
    ``MASKED_BATCH`` x ``TRAIN_SEQ`` in one microbatch; the launch counters
    set to 0 just before each step and read just after.  Checks per step:
    the fused step's launches exactly ``want`` and the unfused step's the
    same with every fused wgrad count moved to its unfused kernel, and
    ``unfused_merges`` (the unfused wgrad's planned split merges), finite
    losses, the momentum stored in bf16 and, leaf by leaf, within the
    reference's bound (2e-2 of the largest entry:
    tests/test_fused_epilogue.py) of the unfused momentum.  ``pin_routing``: the second step of a pair routes as
    the first did (an MoE router's near ties would otherwise move a token's
    gradient by O(1) between the two weight copies).  Returns (stats, the
    fused steps' launches summed)."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.data.synthetic import batch_for
    from repro_torch.training.steps import make_train_step

    opt, lr = fused_opt()
    unfused = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                                  fused_epilogue=False))
    copy = dict(state, params=tree_map_clone(state["params"]),
                opt={"momentum": tree_map_clone(state["opt"]["momentum"])})
    steps = {"fused": make_train_step(cfg, opt, lr), "unfused": make_train_step(unfused, opt, lr)}
    states = {"fused": state, "unfused": copy}
    del state, copy
    read = lambda: {n: getattr(mod, a) for n, mod, a in counters}
    moved = {"block_sparse_dw_fused": "block_sparse_dw",
             "grouped_block_sparse_dw_fused": "grouped_block_sparse_dw",
             "masked_dw_fused": "masked_dw", "grouped_masked_dw_fused": "grouped_masked_dw"}
    want_unfused = dict(want)
    for f, u in moved.items():
        if f in want:
            want_unfused[u], want_unfused[f] = want[f], 0
    want_unfused.update(unfused_merges or {})
    log = []
    for t in range(FUSED_STEPS):
        b = batch_for(cfg, t, MASKED_BATCH, TRAIN_SEQ, learnable=True, device="cuda")
        rec, picks = {"step": t}, []
        for i, side in enumerate(("unfused", "fused") if t % 2 == 0 else ("fused", "unfused")):
            restore = patch_route(record=picks if i == 0 else None,
                                  force=picks if i == 1 else None) if pin_routing else None
            for _, mod, a in counters:
                setattr(mod, a, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                states[side], m = steps[side](states[side], b)
                torch.cuda.synchronize()
            finally:
                if restore is not None:
                    restore()
            rec[f"{side}_wall_s"] = time.perf_counter() - t0
            rec[f"{side}_launches"] = read()
            rec[f"{side}_loss"] = float(m["loss"])
            rec[f"{side}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if rec["fused_launches"] != want or rec["unfused_launches"] != want_unfused or \
                not (math.isfinite(rec["fused_loss"]) and math.isfinite(rec["unfused_loss"])):
            raise AssertionError(f"{label} step {t}: {rec}, expected {want} (fused) and "
                                 f"{want_unfused} (unfused)")
        mom, ref = (tree_paths(states[k]["opt"]["momentum"]) for k in ("fused", "unfused"))
        if any(v.dtype != torch.bfloat16 for v in mom.values()):
            raise AssertionError(f"{label}: the fused step's momentum is not stored in bf16")
        # per leaf: each leaf's difference within 2e-2 of its own largest
        # unfused entry (a leaf of small values is not hidden by another)
        per = {n: ((mom[n].float() - ref[n].float()).abs().max().item(),
                   ref[n].float().abs().max().item()) for n in mom}
        worst = max(per, key=lambda n: per[n][0] / per[n][1] if per[n][1] else
                    (math.inf if per[n][0] else 0.0))
        rec["momentum_vs_unfused"] = {
            "leaves": len(per), "worst_leaf": worst, "max_diff": per[worst][0],
            "max_ref": per[worst][1], "tol": 2e-2 * per[worst][1],
            "max_diff_all": max(d for d, _ in per.values())}
        bad = [n for n, (d, r) in per.items() if not d <= 2e-2 * r]
        if bad:
            raise AssertionError(f"{label}: fused momentum vs unfused beyond 2e-2 of the "
                                 f"leaf's largest entry in {bad[:5]}: "
                                 f"{rec['momentum_vs_unfused']}")
        del mom, ref
        print(f"{label}:", json.dumps(rec))
        log.append(rec)
    del states
    torch.cuda.empty_cache()
    launches = {k: sum(r["fused_launches"][k] for r in log) for k in want}
    stats = {"steps": log, "tokens_per_step": MASKED_BATCH * TRAIN_SEQ,
             "fused_step_wall_s": [r["fused_wall_s"] for r in log],
             "unfused_step_wall_s": [r["unfused_wall_s"] for r in log]}
    return stats, launches


def fused_train(torch, mm):
    """The fused-epilogue train step at full size: SGD momentum 0.9, bf16
    state (in-kernel stochastic rounding), ``sparse.fused_epilogue``,
    masked RigL, batch 2 x 1024 in one microbatch, 2 steps beside unfused
    ones (``fused_steps``): 336 K13, 168 K14 and their planned dx merges,
    168 K19 and their planned fused merges, and no K15 launch or dw merge
    per fused step."""
    from repro_torch.training.steps import init_train_state

    cfg = masked_config(fused_epilogue=True)
    state, _ = init_train_state(cfg, fused_opt()[0], seed=0, device="cuda")
    counters = (("masked_fwd", mm, "launches"), ("masked_dx", mm, "dx_launches"),
                ("masked_dx_merge", mm, "dx_merge_launches"),
                ("masked_dw", mm, "dw_launches"), ("masked_dw_merge", mm, "dw_merge_launches"),
                ("masked_dw_fused", mm, "fused_launches"),
                ("masked_dw_fused_merge", mm, "dw_fused_merge_launches"))
    n_proj = 7 * cfg.n_layers
    merges = {e: cfg.n_layers * planned_merges(torch, mm, cfg, state["params"]["layers"][0],
                                               MASKED_BATCH * TRAIN_SEQ, e)
              for e in ("dx", "dw", "dw_fused")}
    want = {"masked_fwd": 2 * n_proj, "masked_dx": n_proj, "masked_dx_merge": merges["dx"],
            "masked_dw": 0, "masked_dw_merge": 0, "masked_dw_fused": n_proj,
            "masked_dw_fused_merge": merges["dw_fused"]}
    return fused_steps(torch, cfg, state, counters, want, "fused train",
                       unfused_merges={"masked_dw_merge": merges["dw"],
                                       "masked_dw_fused_merge": 0})


def fused_case(torch, timer, kernel, label, run, plain, unfused, check, n_bytes, flops,
               dtype):
    """``kernel_case`` for a fused wgrad epilogue: no one PyTorch call
    computes it (library null); its yardstick is the unfused work it
    replaces on the same inputs, the wgrad kernel then the SGD update
    (``unfused_ms``)."""
    case = kernel_case(torch, timer, kernel, label, run, plain, None, check, n_bytes, flops,
                       dtype)
    case["unfused_ms"] = timer(unfused)
    print(kernel, "unfused", json.dumps({"case": label, "unfused_ms": case["unfused_ms"]}))
    return case


def fused_sweep(torch, timer, mm, case, x, g, wgm, w, mom, seed, acc, absp, dt, tag,
                bn=128, bk=128):
    """K19 (x (M, K)) or K20 (x (G, M, K)) with sr off under every candidate
    plan (``fwd_sweep`` with ``entry="dw_fused"``: each plan within
    ``mm.fused_error_bound`` of the plain version, then timed), added to
    ``case``; the f32 cases' RMS error against the epilogue on a float64
    product over the plain version's (``f64_fidelity``); returns the fused
    merge's case (``merge_case``) where the pick splits."""
    grouped = x.dim() == 3
    M, K, N = x.shape[-2], x.shape[-1], g.shape[-1]
    G = x.shape[0] if grouped else 1
    kw = dict(mu=FUSED_MU, wd=FUSED_WD, sr=False, bn=bn, bk=bk)
    fn = mm.grouped_masked_dw_fused if grouped else mm.masked_dw_fused
    plain = lambda: mm.masked_dw_fused_plain(x, g, wgm, w, mom, seed, mu=FUSED_MU,
                                             wd=FUSED_WD, sr=False)
    want = plain()
    bound = mm.fused_error_bound(want, absp, M, FUSED_MU, FUSED_WD, mom, w, acc, wgm)
    case.update(fwd_sweep(torch, timer, mm, lambda plan: fn(x, g, wgm, w, mom, seed, plan=plan,
                                                            **kw),
                          K, M, N, G, dt, case, entry="dw_fused", bn_limit=bn,
                          check=lambda got: within_tol(torch, tag, got, want, bound)))
    case["dense_tflop_s"] = 2.0 * G * M * K * N / case["ms"] / 1e9
    del want, bound
    if dt == torch.float32:
        case["f64_rms_over_plain"] = f64_fidelity(
            torch, tag, lambda: fn(x, g, wgm, w, mom, seed, **kw), plain,
            lambda: (FUSED_MU * mom.double() + x.double().transpose(-1, -2) @ g.double()
                     + FUSED_WD * w.double()) * wgm)
    print(tag, "plans", json.dumps(case))
    if case["plan"][2] == 1:
        return []
    return [merge_case(torch, timer, mm, case["plan"][2], G, K, N, dt, tag, entry="dw_fused",
                       mask=wgm, fused=(w, mom, seed, FUSED_MU, FUSED_WD, True))]


def fused_checks(torch, tag, run, plain, raw, gid, support, bound):
    """The fused kernels' check: without sr (``raw`` None) every element
    within ``bound()`` of the plain version; with sr bit for bit the plain
    ``sr_to_bf16`` of the kernel's own f32 m_new (``raw()``, the f32-output
    entry with sr off) and on the bf16 grid; zeros off ``support``."""
    from repro_torch.kernels import masked_matmul as mm

    got = run()
    if raw is None:
        want = plain()
        ok, ratio, tol = within(torch, got, want, bound(want))
    else:
        want = mm.sr_to_bf16(raw(), FUSED_SEED, gid()).to(got.dtype)
        ok = torch.equal(got.float(), want.float()) and \
            torch.equal(got.float(), got.to(torch.bfloat16).float())
        ratio, tol = 0.0, 0.0
    if not ok:
        raise AssertionError(f"{tag}: differs from its plain version ({ratio:.3g}x its bound)"
                             if raw is None else f"{tag}: sr differs from sr_to_bf16 of the "
                             "kernel's own m_new, or off the bf16 grid")
    off = got[~support]  # empty where every block is in the support
    if off.numel() and off.float().abs().max().item() != 0:
        raise AssertionError(f"{tag}: m_new off the wgrad support")
    return (got.float() - want.float()).abs().max().item(), ratio, tol


def leaf(tree, path):
    """``tree[path[0]][path[1]]...``."""
    for k in path:
        tree = tree[k]
    return tree


# (label, path under a layer, the dtype the path computes it in)
K7_PROJ = (("mlp.wi", ("mlp", "wi"), "float32"), ("mlp.wo", ("mlp", "wo"), "float32"),
           ("attn.wq", ("attn", "wq"), "bfloat16"))
# qwen2-moe's 2-D projections on the fused MoE paths: attention in bf16, the
# dense shared-expert MLP (ERK density 1.0: every pack slot active) in f32
MOE_FUSED_PROJ = (("attn.wq", ("attn", "wq"), "bfloat16"),
                  ("moe.shared.wi", ("moe", "shared", "wi"), "float32"),
                  ("moe.shared.wo", ("moe", "shared", "wo"), "float32"))


def k7_cases(torch, timer, bsm, state, cfg, proj=K7_PROJ, rows=(2048, 16),
             moms=("bfloat16", "float32"), model="danube"):
    """K7 against its plain version on the fused block-sparse path's own
    layer 0: by default danube's mlp.wi and mlp.wo in f32 and attn.wq in
    bf16 (the dtypes the path runs them in) on their Top-KAST superset
    packs (the path's wgrad packs), at 2048 rows (one microbatch of 2 x
    1024) and 16, sr off and on, mom in bf16 (the path's) and f32; checks
    in ``fused_checks``, the bound ``mm.fused_error_bound``; each case
    also under every candidate plan (``bs_fused_sweep``, with the f32
    cases' float64 fidelity).  Bytes: x and
    g once, w and mom read and m_new written on the superset blocks, the
    zero fill of the rest of the dense (K, N) output; operations 2 M bk bn
    per superset block.  Returns (the cases, the fused merges of split
    picks)."""
    from repro_torch.kernels import masked_matmul as mm

    blk = cfg.sparse.kernel_block[2]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    kw = dict(mu=FUSED_MU, wd=FUSED_WD)
    out, merges = [], []
    for label, path, dname in proj:
        dt = getattr(torch, dname)
        w = leaf(state["params"]["layers"][0], path)["w"].to(dt)
        e = leaf(state["pack"]["layers"][0], path)["w"]
        bidx, bcnt = e["bidx"], e["bcnt"]
        K, N = w.shape
        sup = bsm.unpack_block_mask(bidx, bcnt, K // blk)
        sup = sup.repeat_interleave(blk, 0).repeat_interleave(blk, 1)
        bnnz, es = int(bcnt.sum()), w.element_size()
        for M in rows:
            x, g = rnd(M, K).to(dt), rnd(M, N).to(dt)
            acc = x.float().T @ g.float()
            absp = x.float().abs().T @ g.float().abs()
            for mdt in (getattr(torch, m) for m in moms):
                mom = (0.01 * rnd(K, N) * sup).to(mdt)
                for sr in (False, True):
                    tag = (f"K7 {model} layer0 {label} {dname} M={M} K={K} N={N} superset "
                           f"blocks={bnnz}/{K // blk * N // blk} mom {str(mdt)[6:]} sr={sr}")
                    # each case runs and is timed before the loop moves on
                    run = lambda: bsm.block_sparse_dw_fused(
                        x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=sr, bn=blk, bk=blk,
                        live=bnnz, **kw)
                    plain = lambda: bsm.block_sparse_dw_fused_plain(
                        x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=sr, bk=blk, bn=blk, **kw)
                    raw = None if not sr else lambda: bsm.block_sparse_dw_fused(
                        x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=False, bn=blk, bk=blk,
                        out_dtype=torch.float32, live=bnnz, **kw)
                    unfused = lambda: (FUSED_MU * mom.float() + bsm.block_sparse_dw(
                        x, g, bidx, bcnt, bn=blk, bk=blk, live=bnnz).float()
                        + FUSED_WD * w.float()).to(dt)
                    bound = lambda want: mm.fused_error_bound(
                        want, absp, M, FUSED_MU, FUSED_WD, mom, w, acc, sup)
                    check = lambda: fused_checks(torch, tag, run, plain, raw,
                                                 lambda: mm._gid(K, N, "cuda"), sup, bound)
                    out.append(fused_case(
                        torch, timer, "K7", tag, run, plain, unfused, check,
                        es * (M * K + M * N + K * N) + (es + mom.element_size()) * bnnz * blk * blk
                        + 4 * (bidx.numel() + bcnt.numel()),
                        2.0 * M * bnnz * blk * blk, dt))
                    merges += bs_fused_sweep(torch, timer, bsm, out[-1], x, g, bidx, bcnt, w,
                                             mom, sr, blk, sup, absp, acc, tag)
    return out, merges


def k19_moe_cases(torch, timer, mm, state, cfg, M=2048):
    """K19 against its plain version on the fused masked MoE path's own
    layer 0 (``MOE_FUSED_PROJ``: attn.wq in bf16, the shared MLP's wi and wo
    in f32) on their Top-KAST supersets, at the microbatch's 2048 rows, sr
    off and on, bf16 mom; checks in ``fused_checks``; sr off also under
    every candidate plan, with the f32 cases' float64 fidelity
    (``fused_sweep``).  Bytes and operations as ``masked_cases``' K19;
    yardstick K15 then the SGD update.  Returns (the cases, the fused
    merges of split picks)."""
    blk = cfg.sparse.kernel_block[2]
    gen = torch.Generator(device="cuda").manual_seed(19)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    kw = dict(mu=FUSED_MU, wd=FUSED_WD, bn=blk, bk=blk)
    out, merges = [], []
    for label, path, dname in MOE_FUSED_PROJ:
        dt = getattr(torch, dname)
        w = leaf(state["params"]["layers"][0], path)["w"].to(dt)
        b = leaf(state["bwd_masks"]["layers"][0], path)["w"]
        K, N = w.shape
        bnnz, es = int(b.sum()), w.element_size()
        x, g = rnd(M, K).to(dt), rnd(M, N).to(dt)
        acc = x.float().T @ g.float()
        absp = x.float().abs().T @ g.float().abs()
        mom = (0.01 * rnd(K, N) * b).to(torch.bfloat16)
        for sr in (False, True):
            tag = (f"K19 qwen2-moe layer0 {label} {dname} M={M} K={K} N={N} superset "
                   f"density={bnnz / b.numel():.3f} mom bfloat16 sr={sr}")
            run = lambda: mm.masked_dw_fused(x, g, b, w, mom, FUSED_SEED, sr=sr, **kw)
            plain = lambda: mm.masked_dw_fused_plain(x, g, b, w, mom, FUSED_SEED, sr=sr,
                                                     mu=FUSED_MU, wd=FUSED_WD)
            raw = None if not sr else lambda: mm.masked_dw_fused(
                x, g, b, w, mom, FUSED_SEED, sr=False, out_dtype=torch.float32, **kw)
            unfused = lambda: (FUSED_MU * mom.float() + mm.masked_dw(
                x, g, b, bn=blk, bk=blk).float() + FUSED_WD * w.float()).to(dt)
            bound = lambda want: mm.fused_error_bound(
                want, absp, M, FUSED_MU, FUSED_WD, mom, w, acc, b)
            check = lambda: fused_checks(torch, tag, run, plain, raw,
                                         lambda: mm._gid(K, N, "cuda"), b, bound)
            out.append(fused_case(
                torch, timer, "K19", tag, run, plain, unfused, check,
                es * (M * K + M * N) + K * N * (1 + 2 * es + 2), 2.0 * M * bnnz, dt))
            if not sr:
                merges += fused_sweep(torch, timer, mm, out[-1], x, g, b, w, mom, FUSED_SEED,
                                      acc, absp, dt, tag, bn=blk, bk=blk)
    return out, merges


def fused_bs_config():
    """h2o-danube-1.8b at full width and depth, block_sparse 128x128,
    flash_tight, ERK 0.8, RigL with the Top-KAST superset, the fused SGD
    epilogue, 2 x 1024 tokens in one microbatch."""
    cfg = train_config()
    return dataclasses.replace(cfg, microbatches=1, sparse=dataclasses.replace(
        cfg.sparse, fused_epilogue=True))


def fused_bs_train(torch, timer, bsm, fa):
    """K7 against its plain version on the path's layer 0 (``k7_cases``),
    then 2 fused steps of h2o-danube-1.8b under block_sparse beside unfused
    ones (``fused_steps``): exactly 336 K1 and their planned split merges,
    168 K2 and theirs, 168 K7 and their planned fused merges, no K3 or K3
    merge and 48/24/24 K9-K11 launches per fused step (the unfused step:
    168 K3 and their planned merges in K7's place).  Returns (stats,
    launches, K7's cases, the fused merges' cases)."""
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.training.steps import init_train_state

    cfg = fused_bs_config()
    state, _ = init_train_state(cfg, fused_opt()[0], seed=0, device="cuda")
    cases, merges = k7_cases(torch, timer, bsm, state, cfg)
    counters = (("block_sparse_fwd", bsm, "launches"), ("block_sparse_dx", bsm, "dx_launches"),
                ("block_sparse_dw", bsm, "dw_launches"),
                ("block_sparse_fwd_merge", bsm, "fwd_merge_launches"),
                ("block_sparse_dx_merge", bsm, "dx_merge_launches"),
                ("block_sparse_dw_merge", bsm, "dw_merge_launches"),
                ("block_sparse_dw_fused", bsm, "fused_launches"),
                ("block_sparse_dw_fused_merge", bsm, "dw_fused_merge_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"))
    n_proj, n_attn = 7 * cfg.n_layers, cfg.n_layers
    tokens = MASKED_BATCH * TRAIN_SEQ
    # remat reruns each block's forward in the backward: K1 (with its
    # planned split merges) and K9 twice
    want = {"block_sparse_fwd": 2 * n_proj, "block_sparse_dx": n_proj, "block_sparse_dw": 0,
            "block_sparse_fwd_merge": 2 * bs_merges(torch, cfg, state, tokens, "bs_fwd"),
            "block_sparse_dx_merge": bs_merges(torch, cfg, state, tokens, "bs_dx"),
            "block_sparse_dw_merge": 0, "block_sparse_dw_fused": n_proj,
            "block_sparse_dw_fused_merge": bs_merges(torch, cfg, state, tokens, "bs_dw_fused"),
            "flash_fwd": 2 * n_attn, "flash_dq": n_attn, "flash_dkv": n_attn}
    # K3's planned split merges in the unfused step only, K7's in the fused
    unfused = {"block_sparse_dw_merge": bs_merges(torch, cfg, state, tokens),
               "block_sparse_dw_fused_merge": 0}
    stats, launches = fused_steps(torch, cfg, state, counters, want, "fused block-sparse train",
                                  unfused_merges=unfused)
    return stats, launches, cases, merges


# ---------------------------------------------------------------------------
# paged serving: mistral-large-123b, the prefix cache, K12, the sampler
# ---------------------------------------------------------------------------

PAGED_LAYERS = 4  # of 88: the full model's f32 masters (490 GB) fit no card
PAGED_ENGINE = dict(capacity=4, max_len=592, paged=True, page_size=16)
PREFIX_LEN = 512  # the shared template (a multiple of the page size)


def paged_config():
    """mistral-large-123b at its published widths, 4 layers deep,
    block_sparse (128x128 blocks) with flash_tight attention."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("mistral-large-123b"), kernel="block_sparse",
                           block=128, attn_kernel="flash_tight")
    return dataclasses.replace(cfg, n_layers=PAGED_LAYERS)


def prefix_requests(cfg, n=8, gen=32, seed=0, sampled=(2, 5)):
    """The reference's shared-prefix scenario (benchmarks/serve_bench.py::
    _prefix_requests): ``n`` requests on one ``PREFIX_LEN``-token template
    plus 4-11 random suffix tokens, ``gen`` new tokens each, declaring the
    template as shared; the requests of ``sampled`` draw at temperature 0.8
    with top-k 40, the others are greedy."""
    import numpy as np
    from repro_torch.serving.queue import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, size=PREFIX_LEN).astype(np.int32)
    reqs = []
    for i in range(n):
        suffix = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 12))).astype(np.int32)
        hot = i in sampled
        reqs.append(Request(rid=i, tokens=np.concatenate([prefix, suffix]),
                            max_new_tokens=gen, share_prefix_len=PREFIX_LEN,
                            temperature=0.8 if hot else 0.0, top_k=40 if hot else 0,
                            seed=seed + i))
    return reqs


def k12_cases(torch, timer, fa):
    """K12 against its plain version at mistral-large's attention widths: 4
    rows of suffix queries (96 heads over 8 KV heads, head_dim 128, bf16),
    Sq 16 and 128, a table of 256 pages of 16 per row into a pool of 1024
    shuffled pages, ctx 0, 100 (inside a page), 2047 and 4096 (the whole
    table) with sentinel tails, and a softcap case.  o element by element
    within ``fa.o_error_bound`` (the kernel rounds p to bf16, both round o),
    lse within 1e-3 (f32 in both) and exactly -1e30 where ctx = 0.  The
    yardstick is scaled_dot_product_attention on the table-gathered prefix
    with a key-padding mask, timed alone (the gather outside its events).
    A last case runs the paged-serve path's own shape: one 16-row suffix
    over a 37-page table at ctx 512.  Each case also reports the achieved
    TFLOP/s, its share of the bound, the plan's n_split and the launch the
    kernel gets (CTAs resident per SM, registers, shared and spill bytes)."""
    import numpy as np

    F = torch.nn.functional
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    B, H, KV, d, bs, T, N = 4, 96, 8, 128, 16, 256, 1024
    ctxs = [0, 100, 2047, 4096]
    rng = np.random.default_rng(12)
    table = np.full((B, T), N, np.int32)
    perm = rng.permutation(N)
    for b, c in enumerate(ctxs):
        n = -(-c // bs)
        table[b, :n] = perm[:n]
        perm = perm[n:]
    table = torch.from_numpy(table).cuda()
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    pk = torch.randn(N, bs, KV, d, device="cuda").to(torch.bfloat16)
    pv = torch.randn(N, bs, KV, d, device="cuda").to(torch.bfloat16)
    out = []
    for Sq, softcap in ((16, 0.0), (128, 0.0), (16, 30.0), (16, None)):
        if softcap is None:  # the paged-serve path's own shape: one suffix
            # of 16 (padded) over its 37-page table, ctx 512
            softcap, B, ctxs, T, N = 0.0, 1, [PREFIX_LEN], 37, 148
            table = torch.arange(T, dtype=torch.int32, device="cuda")[None]
            ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            pk, pv = pk[:N], pv[:N]
        live_keys = sum(-(-c // bs) * bs for c in ctxs)
        q = torch.randn(B, H, Sq, d, device="cuda").to(torch.bfloat16)
        o, lse = fa.flash_attention_paged(q, pk, pv, table, ctx, softcap=softcap)
        po, plse = fa.flash_attention_paged_plain(q, pk, pv, table, ctx, softcap=softcap)
        pa, _ = fa.flash_attention_paged_plain(q, pk, pv.abs(), table, ctx, softcap=softcap)
        diff = (o.float() - po.float()).abs()
        bound = fa.o_error_bound(po, pa)
        ratio = (diff / bound.clamp_min(1e-30)).max().item()
        live = plse > -1e29
        err_l = (lse[live] - plse[live]).abs().max().item()
        empty_ok = bool((lse[~live] == -1e30).all()) and \
            int((~live).sum()) == H * Sq * ctxs.count(0)
        if not (bool((diff <= bound).all()) and err_l <= 1e-3 and empty_ok):
            raise AssertionError(
                f"K12 Sq={Sq} softcap={softcap}: o over its bound {ratio:.3g}x "
                f"(max err {diff.max().item()}), lse err {err_l}, ctx=0 rows ok {empty_ok}")
        # bytes: q and o once, lse, the live K/V pages once per KV head, the
        # table and ctx; operations: 4 d per (query, live key) pair
        n_bytes = 2 * 2 * B * H * Sq * d + 4 * B * H * Sq + 2 * 2 * live_keys * KV * d \
            + 4 * (table.numel() + B)
        flops = 4.0 * d * Sq * sum(ctxs) * H
        b_ms, by = bound_ms(n_bytes, flops)
        lib_ms = None
        if not softcap:  # SDPA has no softcap
            tab = table.long().clamp(0, N - 1)
            kg = pk[tab].reshape(B, T * bs, KV, d).transpose(1, 2)
            vg = pv[tab].reshape(B, T * bs, KV, d).transpose(1, 2)
            mask = (torch.arange(T * bs, device="cuda")[None, :] < ctx[:, None].long())
            mask = mask[:, None, None, :]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask, enable_gqa=True), reps=5)
        ms = timer(lambda: fa.flash_attention_paged(q, pk, pv, table, ctx,
                                                    softcap=softcap), reps=5)
        n_split, _ = fa.paged_split_plan(B, KV, (H // KV) * Sq, T, bs, n_sm)
        case = {
            "case": f"Sq={Sq} softcap={softcap} B={B} H={H} KV={KV} d={d} "
                    f"pages {T}x{bs} ctx={ctxs}",
            "max_abs_err": diff.max().item(), "lse_err": err_l, "lse_tol": 1e-3,
            "tol": "2**-7 |o| + 1.25 * 2**-8 (p @ |v|) / l, per element",
            "err_over_tol": ratio,
            "ms": ms,
            "plain_ms": timer(lambda: fa.flash_attention_paged_plain(
                q, pk, pv, table, ctx, softcap=softcap), reps=2, warmup=1),
            "library_ms": lib_ms, "library": "SDPA on the gathered prefix, alone",
            "bound_ms": b_ms, "bound_by": by,
            "tflop_s": flops / ms / 1e9, "share_of_bound": b_ms / ms,
            "n_split": n_split, "launch": fa.launch_info("flash_paged", d),
        }
        print("K12", json.dumps(case))
        out.append(case)
    return out


def paged_serve(torch, timer, bsm, fa, cfg=None, label="paged serve", of=88):
    """Serve mistral-large-123b (4 layers, full width, block_sparse,
    flash_tight, ERK 0.8, seed 0), or ``cfg`` (command-r-plus-104b: phase
    "command-r serve", which also holds the greedy streams to the plain
    dense path's) through the paged engine with the prefix
    cache: 8 requests on one 512-token template, 2 of them sampled; every
    request DONE with 32 tokens, 1 prefix miss and 7 hits, the pool books
    clean, exactly 28 K12 launches (7 suffix prefills x 4 layers), K9 and
    K1 launched.  Then: the first-token logits of a suffix prefill against
    a full paged prefill of the same prompt; the greedy streams of a paged
    engine without the prefix cache and of the contiguous engine, which
    must be the same; K1 on layer 0's served packs."""
    import numpy as np
    from repro_torch.launch.serve import init_serving_state
    from repro_torch.models.model import (
        init_paged_caches,
        lm_decode,
        lm_prefill_into,
        lm_prefill_suffix,
    )
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    dense_check = cfg is not None
    cfg = cfg or paged_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    kw = dict(masks=masks, pack=pack, **PAGED_ENGINE)
    engine = ServeEngine(cfg, params, prefix_cache=4, **kw)
    del params
    torch.cuda.synchronize()
    print(f"{label}: {cfg.name} ({cfg.n_layers} of {of} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}) "
          f"initialised in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    params = engine.params
    # warm-up on another template (a miss and a hit), before the counted run
    for r in prefix_requests(cfg, 2, gen=2, seed=1, sampled=(1,)):
        engine.submit(r)
    engine.run()

    reqs = prefix_requests(cfg)
    engine = ServeEngine(cfg, params, prefix_cache=4, **kw)
    for r in reqs:
        engine.submit(r)
    fa.paged_launches = fa.launches = bsm.launches = bsm.fwd_merge_launches = 0
    stats = engine.run()
    launches = {"paged_flash_fwd": fa.paged_launches, "flash_fwd": fa.launches,
                "block_sparse_fwd": bsm.launches}
    engine.check_pool_accounting()
    n_full = stats["prefills"] - stats["suffix_prefills"]
    stats["full_prefill_ms"] = 1e3 * (stats["prefill_s"] - stats["suffix_prefill_s"]) / max(n_full, 1)
    stats["suffix_prefill_ms"] = 1e3 * stats["suffix_prefill_s"] / max(stats["suffix_prefills"], 1)
    stats["decode_step_ms"] = 1e3 * stats["decode_step_s"]
    print(f"{label}: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "suffix_prefills",
        "prefix_hits", "prefix_misses", "kv_forks", "pages_live", "quarantined",
        "failed", "wall_s", "tok_per_s")}))
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != 32:
            raise AssertionError(f"paged request {r.rid}: {r.status} with "
                                 f"{len(r.generated)} tokens")
    if stats["quarantined"] or stats["failed"]:
        raise AssertionError(f"paged serve: quarantined/failed slots: {stats}")
    if (stats["prefix_misses"], stats["prefix_hits"]) != (1, 7):
        raise AssertionError(f"paged serve: {stats['prefix_misses']} misses and "
                             f"{stats['prefix_hits']} hits, expected 1 and 7")
    if launches["paged_flash_fwd"] != 7 * cfg.n_layers or not all(launches.values()):
        raise AssertionError(f"paged serve: launches {launches}, expected "
                             f"{7 * cfg.n_layers} K12")
    launches["block_sparse_fwd_merge"] = bsm.fwd_merge_launches

    # a suffix prefill's first-token logits against a full paged prefill of
    # the same prompt (the same prefix pages, written by the full prefill)
    req = reqs[0]
    L, ctx, bs = req.prompt_len, PREFIX_LEN, PAGED_ENGINE["page_size"]
    max_len = PAGED_ENGINE["max_len"]
    T = max_len // bs
    caches = init_paged_caches(cfg, {"global": 2 * T}, bs, "cuda")
    full_tab = torch.arange(T, dtype=torch.int32, device="cuda")
    sfx_tab = full_tab.clone()
    sfx_tab[ctx // bs:] += T  # fresh pages after the shared prefix
    pad = lambda a, n: torch.from_numpy(np.pad(a, (0, n - len(a))).astype(np.int64))[None].cuda()
    full, _ = lm_prefill_into(params, cfg, caches, {"tokens": pad(req.tokens, max_len)}, 0,
                              max_len, masks=masks, pack=pack, n_valid=L,
                              tables={"global": full_tab})
    n0 = fa.paged_launches
    sfx, _ = lm_prefill_suffix(params, cfg, caches, {"tokens": pad(req.tokens[ctx:], 16)},
                               sfx_tab, ctx, masks=masks, pack=pack, n_valid=L - ctx)
    V = cfg.vocab_size
    a, b = sfx.float()[..., :V], full.float()[..., :V]
    if not bool(torch.isfinite(a).all()) or a.shape != (1, 1, V) \
            or fa.paged_launches - n0 != cfg.n_layers:
        raise AssertionError("suffix logits not finite, of the wrong shape, or K12 not run")
    err, tol = (a - b).abs().max().item(), 2e-2 * b.abs().max().item()
    stats["suffix_vs_full_logit_err"], stats["suffix_vs_full_logit_tol"] = err, tol
    print(f"{label}: suffix vs full prefill logits: max err {err:.4g} (tol "
          f"{tol:.4g}); top-1 {int(a.argmax())} vs {int(b.argmax())}")
    if err > tol:
        raise AssertionError("suffix prefill logits differ from the full prefill")
    del caches

    # paged (no prefix cache) against contiguous decode: the greedy streams
    streams = {}
    for name, extra in (("paged", {}), ("contiguous", {"paged": False})):
        eng = ServeEngine(cfg, params, **dict(kw, **extra))
        rs = prefix_requests(cfg)
        for r in rs:
            eng.submit(r)
        st = eng.run()
        stats[f"{name}_no_prefix_tok_per_s"] = st["tok_per_s"]
        streams[name] = rs
    greedy = [i for i, r in enumerate(reqs) if r.temperature <= 0.0]
    same = [streams["paged"][i].generated == streams["contiguous"][i].generated
            for i in range(len(reqs))]
    stats["greedy_streams_identical"] = all(same[i] for i in greedy)
    stats["sampled_streams_identical"] = all(same[i] for i in range(len(reqs)) if i not in greedy)
    stats["prefix_vs_no_prefix_identical"] = [
        reqs[i].generated == streams["paged"][i].generated for i in range(len(reqs))]
    print(f"{label}: paged vs contiguous engine, greedy streams identical "
          f"{stats['greedy_streams_identical']}, sampled "
          f"{stats['sampled_streams_identical']}; prefix-cache vs paged streams "
          f"identical {stats['prefix_vs_no_prefix_identical']}")
    if not stats["greedy_streams_identical"]:
        raise AssertionError("paged greedy streams differ from the contiguous engine's")
    if dense_check:
        # the plain dense path (kernel='dense', attn_kernel='dense') on the
        # same weights, with the prefix cache: the greedy streams
        dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
            cfg.sparse, kernel="dense", attn_kernel="dense"))
        deng = ServeEngine(dense, params, prefix_cache=4, **PAGED_ENGINE)
        drs = prefix_requests(cfg)
        for r in drs:
            deng.submit(r)
        deng.run()
        del deng
        stats["greedy_streams_equal_dense"] = [reqs[i].generated == drs[i].generated
                                               for i in greedy]
        print(f"{label}: vs the plain dense path: greedy streams equal "
              f"{stats['greedy_streams_equal_dense']}")
        if not all(stats["greedy_streams_equal_dense"]):
            raise AssertionError(f"{label}: greedy streams differ from the dense path's")
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode,
                                                      label)
    k1_ms, n_calls, n_merges = k1_decode_ms(torch, bsm, engine)
    stats["k1_decode_step_ms"], stats["k1_decode_step_merges"] = k1_ms, n_merges
    print(f"{label}: K1 in one decode step: {n_calls} launches and {n_merges} split "
          f"merges, {k1_ms:.3f} ms device time (CUDA-graph replay), "
          f"{k1_ms / stats['decode_step_device_ms']:.1%} of the step's device time")
    print(f"{label}: prefill {stats['full_prefill_ms']:.2f} ms per full and "
          f"{stats['suffix_prefill_ms']:.2f} ms per suffix admission, decode "
          f"{stats['decode_step_ms']:.2f} ms/step (capacity 4), "
          f"{stats['tok_per_s']:.2f} tok/s end to end, peak {stats['peak_gib']:.1f} GiB; "
          f"launches {launches}")
    served = k1_served_cases(torch, timer, bsm, engine, rows=(4, max_len))
    return stats, launches, served


# ---------------------------------------------------------------------------
# MoE serving: qwen2-moe-a2.7b, the grouped kernels K4 (block-sparse) and K16
# (masked) over the 60 experts' banks
# ---------------------------------------------------------------------------

MOE_LAYERS = 12  # of 24: init holds the f32 masters twice while applying masks
MOE_ENGINE = dict(capacity=4, max_len=2048)
MOE_BANKS = ("wi", "wg", "wo")
MOE_PROJ = 7  # K1/K13 launches per layer: wq, wk, wv, wo and the shared MLP's 3


def moe_config(kernel):
    """qwen2-moe-a2.7b at its published widths, 12 layers deep, ERK 0.8,
    flash_tight; block_sparse in 128x128 blocks or masked."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("qwen2-moe-a2.7b"), kernel=kernel,
                           block=128 if kernel == "block_sparse" else None,
                           attn_kernel="flash_tight")
    return dataclasses.replace(cfg, n_layers=MOE_LAYERS)


def _check_within(torch, tag, got, want, absp, n, dtype):
    """Element by element within ``matmul_error_bound``; bf16 also within one
    ulp of the largest output (both sides round once)."""
    from repro_torch.kernels.block_sparse_matmul import matmul_error_bound

    ok, ratio, tol = within(torch, got, want, matmul_error_bound(want, absp, n))
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.bfloat16:
        ok = ok and err <= 2.0**-7 * want.float().abs().max().item()
    if not ok:
        raise AssertionError(f"{tag}: err {err} exceeds its bound ({ratio:.3g}x)")
    return err, ratio, tol


def bank_topologies(torch, rng, w_erk, e_erk, blk, superset=False):
    """The topologies the grouped block-sparse kernels are held on, for one
    (G, K, N) bank: layer 0's ERK weights and pack entry as given, a
    uniform 20% block mask with one empty column, and that mask with
    experts 5 and 40 of 60 dead, both on random weights.  With
    ``superset`` their packs carry a Top-KAST superset (the mask and 10%
    of the blocks; none for the dead experts).  Returns the dead experts'
    ids and [(name, weights, pack entry)]."""
    import numpy as np
    from repro_torch.core.pack import pack_entry

    G, K, N = w_erk.shape
    bm_u = np.stack([uniform_blocks(rng, K, N, blk) for _ in range(G)])
    sup_u = bm_u | (rng.random(bm_u.shape) < 0.1) if superset else None
    dead_ids = [G // 12, 2 * G // 3]
    dead = bm_u.copy()
    dead[dead_ids] = False
    sup_d = None
    if superset:
        sup_d = sup_u.copy()
        sup_d[dead_ids] = False
    dense_of = lambda b: torch.from_numpy(np.repeat(np.repeat(b, blk, 1), blk, 2)).cuda()
    w_rand = torch.randn(G, K, N, device="cuda") / K**0.5
    topo = [("layer0 ERK", w_erk, e_erk)]
    names = ("uniform 20% + 10% superset" if superset else "uniform 20%",
             f"uniform 20% experts {dead_ids} dead")
    for tname, b, s_ in zip(names, (bm_u, dead), (sup_u, sup_d)):
        kw = {} if s_ is None else {"bwd_mask": dense_of(s_)}
        topo.append((tname, w_rand * dense_of(b), pack_entry(dense_of(b), (blk, blk), **kw)))
    return dead_ids, topo


def grouped_rows(torch, G, C, width, dt):
    """A random (G, C, width) input in ``dt`` and its copy zero-padded to
    the row tile, as the grouped wrappers pad it: (bm, Mp, t, padded)."""
    from repro_torch.kernels.ops import _row_tile

    bm, Mp = _row_tile(C, 128)
    t = torch.randn(G, C, width, device="cuda").to(dt)
    return bm, Mp, t, torch.nn.functional.pad(t, (0, 0, 0, Mp - C))


def k4_cases(torch, timer, bsm, engine):
    """K4 against its plain version at the MoE path's shapes: the 60-expert
    banks (2048 -> 1408, as wi/wg, and 1408 -> 2048, as wo) at C = 4 rows
    (a capacity-4 decode step, padded to 16) and C = 84 (a 1000-token
    prefill, padded to 96), f32 (the path's dtype) and bf16, on
    ``bank_topologies``, on the plan from the pack's live blocks and under
    every candidate plan (``fwd_sweep``, entry "bs_fwd"), the f32 cases
    also against a float64 product (``bs_fwd_fidelity``).  Bytes: x, the
    active blocks and y once; operations: 2 C bk bn per active block.
    Library: torch.bmm on the zero-filled dense bank (TF32 off)."""
    import numpy as np
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels.ops import grouped_block_sparse_linear

    rng = np.random.default_rng(4)
    blk = engine.cfg.sparse.kernel_block[2]
    lay = engine.params["layers"][0]["moe"]
    pk = engine.pack["layers"][0]["moe"]
    out = []
    for bank in ("wi", "wo"):
        G, K, N = lay[bank]["w"].shape
        dead_ids, topo = bank_topologies(torch, rng, lay[bank]["w"], pk[bank]["w"], blk)
        for tname, w32, e in topo:
            idx, cnt = e["idx"], e["cnt"]
            nnz = int(cnt.sum())
            for dt in (torch.float32, torch.bfloat16):
                w = w32.to(dt)
                for C in (4, 84):
                    bm, Mp, x, xp = grouped_rows(torch, G, C, K, dt)
                    tag = f"K4 {bank} {tname} {str(dt)[6:]}"
                    plain = lambda: bsm.grouped_block_sparse_matmul_plain(xp, w, idx, cnt,
                                                                           blk, blk)

                    def check():
                        got = grouped_block_sparse_linear(x, w, pack=e, block=(128, blk, blk))
                        want = plain()[:, :C]
                        absp = bsm.grouped_block_sparse_matmul_plain(
                            xp.abs().float(), w.abs().float(), idx, cnt, blk, blk)[:, :C]
                        res = _check_within(torch, tag, got, want, absp, K, dt)
                        if tname != "layer0 ERK" and \
                                got[:, :, blk:2 * blk].float().abs().max().item() != 0:
                            raise AssertionError(f"{tag}: the empty column is not zero")
                        if "dead" in tname and got[dead_ids].float().abs().max().item() != 0:
                            raise AssertionError(f"{tag}: a dead expert's output is not zero")
                        return res

                    es = x.element_size()
                    run = lambda plan=None: bsm.grouped_block_sparse_matmul(
                        xp, w, idx, cnt, bm=bm, bn=blk, bk=blk, plan=plan, live=nnz)
                    case = kernel_case(
                        torch, timer, "K4",
                        f"{tag} G={G} C={C}->{Mp} K={K} N={N} "
                        f"blocks={nnz}/{G * (K // blk) * (N // blk)} width={idx.shape[-1]}",
                        run, plain, lambda: torch.bmm(x, w), check,
                        es * (G * C * K + nnz * blk * blk + G * C * N)
                        + 4 * (idx.numel() + cnt.numel()),
                        2.0 * C * nnz * blk * blk, dt)
                    want = plain()
                    absp = bsm.grouped_block_sparse_matmul_plain(
                        xp.abs().float(), w.abs().float(), idx, cnt, blk, blk)
                    case.update(fwd_sweep(
                        torch, timer, mm, run, Mp, K, N, G, dt, case, entry="bs_fwd",
                        check=lambda got: _check_within(torch, tag, got, want, absp, K, dt),
                        bn_limit=blk, live=nnz, bk=blk))
                    del want, absp
                    if dt == torch.float32:
                        case["f64_rms_over_plain"] = bs_fwd_fidelity(
                            torch, bsm, tag, run, xp, w, idx, cnt, blk, case["plan"])
                    print("K4 plans", json.dumps(case))
                    if case["plan"][2] > 1:
                        case["merge_case"] = merge_case(torch, timer, mm, case["plan"][2], G,
                                                        Mp, N, dt, case["case"], entry="bs_fwd")
                    out.append(case)
    return out


def k16_cases(torch, timer, mm, engine):
    """K16 against its plain version on layer 0's served banks and
    elementwise ERK masks (wi 2048 -> 1408, wo 1408 -> 2048), at C = 4 (->
    16) and 84 (-> 96) rows, f32 and bf16, each also under every candidate
    plan (``fwd_sweep``).  Bytes: x, y, w and its 1-byte mask once;
    operations: 2 C per active weight.  Library: torch.bmm on the
    pre-masked bank (TF32 off)."""
    from repro_torch.kernels.ops import grouped_masked_linear

    blk = engine.cfg.sparse.kernel_block[2]
    out = []
    for bank in ("wi", "wo"):
        w32 = engine.params["layers"][0]["moe"][bank]["w"]
        m = engine.masks["layers"][0]["moe"][bank]["w"]
        G, K, N = w32.shape
        nnz = int(m.sum())
        for dt in (torch.float32, torch.bfloat16):
            w = w32.to(dt)
            wm = w * m
            for C in (4, 84):
                bm, Mp, x, xp = grouped_rows(torch, G, C, K, dt)
                tag = f"K16 {bank} layer0 ERK {str(dt)[6:]}"
                plain = lambda: mm.grouped_masked_matmul_plain(xp, w, m)

                def check():
                    got = grouped_masked_linear(x, w, m, block=(128, blk, blk))
                    want = plain()[:, :C]
                    absp = mm.grouped_masked_matmul_plain(xp.abs().float(), w.abs().float(),
                                                          m)[:, :C]
                    return _check_within(torch, tag, got, want, absp, K, dt)

                es = x.element_size()
                case = kernel_case(
                    torch, timer, "K16",
                    f"{tag} G={G} C={C}->{Mp} K={K} N={N} density={nnz / m.numel():.4f}",
                    lambda: mm.grouped_masked_matmul(xp, w, m, bm=bm, bn=blk), plain,
                    lambda: torch.bmm(x, wm), check,
                    es * (G * C * K + G * C * N) + (es + 1) * G * K * N,
                    2.0 * C * nnz, dt)
                case.update(fwd_sweep(torch, timer, mm, lambda plan: mm.grouped_masked_matmul(
                    xp, w, m, bm=bm, bn=blk, plan=plan), Mp, K, N, G, dt, case))
                print("K16 plans", json.dumps(case))
                out.append(case)
    return out


def patch_route(record=None, force=None):
    """Wrap ``models/moe.py::route`` for one run: ``record`` (a list) gets
    every call's top-k expert ids (T, K); ``force`` (the ids a run
    recorded, in call order) replaces the picks, the gates renormalised
    over the forced experts' own probabilities.  Returns the restore."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.route
    forced = None if force is None else iter(force)

    def route(p, xt, cfg):
        probs, gates, eidx = real(p, xt, cfg)
        if forced is not None:
            eidx = next(forced)
            gates = probs.gather(1, eidx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        if record is not None:
            record.append(eidx)
        return probs, gates, eidx

    moe_mod.route = route
    return lambda: setattr(moe_mod, "route", real)


def moe_vs_dense(torch, cfg, params, masks, pack, prompts, probes, label):
    """Each prompt's prefill (exact length) and one decode step on the
    kernel path and on the plain dense path (dense matmuls on w * m, plain
    attention) over the same weights.  Routing is discrete: where the two
    paths' residuals (bf16 flash vs plain attention, one bf16 rounding
    apart here and there) straddle a near tie of the 4th and 5th expert, a
    top-4 set differs and that token's output moves by O(1).  So:

      * the share of (token, layer) top-4 sets that agree is reported and
        must be at least 95% (a broken router agrees on a few per cent);
      * the logits of every prompt (served or a 4-token probe) whose
        routing agreed at every token and layer are held within 2e-2 of
        the largest logit (the block-sparse serving phase's tolerance);
        at least one must qualify;
      * each served prompt is also run on the dense path with its routing
        pinned to the kernel path's picks: all of their logits within the
        same tolerance."""
    import numpy as np
    from repro_torch.models.model import lm_decode, lm_prefill

    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))
    V = cfg.vocab_size

    def run(c, t, record=None, force=None):
        restore = patch_route(record, force)
        try:
            logits, caches = lm_prefill(params, c, {"tokens": t}, t.shape[1] + 1,
                                        masks=masks, pack=pack)
            nxt = logits[:, -1].argmax(-1)[:, None]
            step, _ = lm_decode(params, c, caches, nxt, t.shape[1], masks=masks, pack=pack)
        finally:
            restore()
        out = (logits.float()[..., :V], step.float()[..., :V])
        if any(not bool(torch.isfinite(a).all()) or a.shape != (1, 1, V) for a in out):
            raise AssertionError(f"{label}: logits not finite or of the wrong shape")
        return out

    def held(a_pair, b_pair, what):
        worst = 0.0
        for a, b in zip(a_pair, b_pair):
            err, tol = (a - b).abs().max().item(), 2e-2 * b.abs().max().item()
            worst = max(worst, err / tol)
            if err > tol:
                raise AssertionError(f"{label}: {what} logits err {err} > {tol}")
        return worst

    agree = total = 0
    lens_agree, worst_agree, worst_pinned = [], 0.0, 0.0
    for i, toks in enumerate(list(prompts) + list(probes)):
        t = torch.from_numpy(np.asarray(toks)).long().cuda()[None]
        rk, rd = [], []
        kern = run(cfg, t, record=rk)
        dens = run(dense, t, record=rd)
        rows = torch.cat([(a.sort(-1).values == b.sort(-1).values).all(-1)
                          for a, b in zip(rk, rd)])
        agree += int(rows.sum())
        total += rows.numel()
        if bool(rows.all()):
            lens_agree.append((len(toks), i < len(prompts)))
            worst_agree = max(worst_agree, held(kern, dens, "routing-agreeing prompt's"))
        if i < len(prompts):
            pinned = run(dense, t, force=rk)
            worst_pinned = max(worst_pinned, held(kern, pinned, "pinned-routing"))
    out = {"routing_agreement": agree / total, "routing_decisions": total,
           "prompts": len(prompts), "probes": len(probes),
           "served_all_agree": [n for n, served in lens_agree if served],
           "probes_all_agree": sum(not served for _, served in lens_agree),
           "all_agree_err_over_tol": worst_agree, "pinned_err_over_tol": worst_pinned}
    print(f"{label}: routing vs the dense path: {agree}/{total} (token, layer) top-4 "
          f"sets agree ({agree / total:.4%}); served prompts that agreed everywhere: "
          f"lengths {out['served_all_agree']} of {[len(p) for p in prompts]}, probes "
          f"{out['probes_all_agree']} of {len(probes)}; their logits at "
          f"{worst_agree:.3g} of the 2e-2 tolerance; the served prompts "
          f"with the dense path's routing pinned to the kernel path's: "
          f"{worst_pinned:.3g} of it")
    if agree / total < 0.95 or not lens_agree:
        raise AssertionError(f"{label}: routing agreement {agree / total:.4f} < 0.95 or "
                             "no prompt agreed in every layer")
    return out


def dead_slot_check(torch, cfg, params, masks, pack, label):
    """The dead-slot invariant on the card: capacity 8 (C = 4 binds), active
    requests in slots 4-7, dead slots 0-3 holding varied stale tokens and
    positions: the active rows' logits are bit-identical."""
    import numpy as np
    from repro_torch.models.model import init_caches, lm_decode, lm_prefill_into
    from repro_torch.models.moe import capacity

    cap, max_len = 8, 16
    if capacity(cap, cfg) >= cap:
        raise AssertionError("dead-slot check: C does not bind")
    caches = init_caches(cfg, cap, max_len, "cuda")
    pos = np.zeros(cap, np.int64)
    active = np.zeros(cap, bool)
    cur = np.zeros(cap, np.int64)
    for i in range(4):
        t = np.random.default_rng(40 + i).integers(0, cfg.vocab_size, (1, 4))
        logits, caches = lm_prefill_into(params, cfg, caches,
                                         {"tokens": torch.from_numpy(t).cuda()}, 4 + i,
                                         max_len, masks=masks, pack=pack)
        cur[4 + i], pos[4 + i], active[4 + i] = int(logits[0, -1].argmax()), 4, True

    def active_logits(dead_tok, dead_pos):
        tok, p = cur.copy(), pos.copy()
        tok[:4], p[:4] = dead_tok, dead_pos
        logits, _ = lm_decode(params, cfg, caches, torch.from_numpy(tok)[:, None].cuda(),
                              torch.from_numpy(p).cuda(), masks=masks, pack=pack,
                              active=torch.from_numpy(active).cuda())
        return logits[4:, -1].clone()

    ref = active_logits(0, 0)
    same = all(torch.equal(active_logits(t, p), ref)
               for t, p in ((1, 0), (97, 3), (cfg.vocab_size - 1, 9)))
    print(f"{label}: active logits bit-identical under changed dead slots: {same}")
    if not same:
        raise AssertionError(f"{label}: dead-slot contents leaked into active logits")
    return same


def moe_serve(torch, timer, bsm, mm, fa, kernel):
    """Serve qwen2-moe-a2.7b (12 of 24 layers, full width, ERK 0.8, seed 0,
    flash_tight) under ``kernel``: block_sparse (128x128 blocks, K4 for the
    banks, K1 for attention and the shared MLP) with slice 1's scenario (8
    staggered greedy requests, prompts 100/300/1000, 32 tokens, capacity
    4), or masked (K16 and K13) with 4 requests of prompts 100/300, 16
    tokens.  Checks: every request DONE, nothing quarantined; the exact
    launches of the run (per prefill and per decode step: 3 grouped x 12,
    7 projections x 12, and K9 12 per prefill) and of one decode step; the
    dead-slot invariant; routing agreement and logits against the plain
    dense path.  Then the decode step's device time (CUDA graph), the
    grouped kernel's share of it, the kernel cases on layer 0."""
    import numpy as np
    from repro_torch.core.pack import pack_stats
    from repro_torch.launch.serve import init_serving_state, staggered_requests
    from repro_torch.models.model import lm_decode
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    label = f"moe serve {kernel}"
    bs = kernel == "block_sparse"
    gmod, pmod = (bsm, bsm) if bs else (mm, mm)
    gname, pname = ("grouped_block_sparse_fwd", "block_sparse_fwd") if bs else \
        ("grouped_masked_fwd", "masked_fwd")
    cfg = moe_config(kernel)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    engine = ServeEngine(cfg, params, masks=masks, pack=pack, **MOE_ENGINE)
    del params
    torch.cuda.synchronize()
    print(f"{label}: qwen2-moe-a2.7b ({cfg.n_layers} of 24 layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, "
          f"{cfg.n_shared_experts} shared) initialised in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    stats = {}
    if bs:
        banks = {n: v for n, v in pack_stats(pack)["layers"].items() if "/moe/w" in n}
        widths = [v["width"] for v in banks.values()]
        means = [v["nnz_blocks"] / (v["groups"] * v["cols"]) for v in banks.values()]
        stats["bank_width"] = {"min": min(widths), "max": max(widths),
                               "mean": sum(widths) / len(widths)}
        stats["bank_mean_active_per_column"] = sum(means) / len(means)
        stats["bank_worst_case"] = sorted({v["worst_case"] for v in banks.values()})
        print(f"{label}: bank pack widths {stats['bank_width']} (worst cases "
              f"{stats['bank_worst_case']}) against a mean of "
              f"{stats['bank_mean_active_per_column']:.3f} active blocks per column")
    for r in staggered_requests(cfg, 2, prompt_lens=(100,), gen_lens=(2,), seed=1):
        engine.submit(r)
    engine.run()

    n_req, lens, gen = (8, (100, 300, 1000), 32) if bs else (4, (100, 300), 16)
    reqs = staggered_requests(cfg, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
    engine = ServeEngine(cfg, engine.params, masks=masks, pack=pack, **MOE_ENGINE)
    for r in reqs:
        engine.submit(r)
    fa.launches = gmod.g_launches = pmod.launches = gmod.fwd_merge_launches = 0
    stats.update(engine.run())
    launches = {gname: gmod.g_launches, pname: pmod.launches, "flash_fwd": fa.launches}
    merges_run = gmod.fwd_merge_launches
    print(f"{label}: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "quarantined", "failed",
        "wall_s", "tok_per_s", "prefill_s", "decode_step_s")}))
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != gen:
            raise AssertionError(f"{label}: request {r.rid}: {r.status} with "
                                 f"{len(r.generated)} tokens")
    if stats["quarantined"] or stats["failed"]:
        raise AssertionError(f"{label}: quarantined/failed slots: {stats}")
    L, calls = cfg.n_layers, stats["decode_steps"] + stats["prefills"]
    expect = {gname: len(MOE_BANKS) * L * calls, pname: MOE_PROJ * L * calls,
              "flash_fwd": L * stats["prefills"]}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")
    launches[f"{pname}_merge"] = merges_run
    n0, p0, m0 = gmod.g_launches, pmod.launches, gmod.fwd_merge_launches
    step = lambda: lm_decode(engine.params, cfg, engine.caches,
                             torch.from_numpy(engine.cur_tok[:, None]).cuda(),
                             torch.from_numpy(engine.pos).cuda(), masks=masks, pack=pack)
    step()
    stats["grouped_launches_per_decode_step"] = gmod.g_launches - n0
    stats["proj_launches_per_decode_step"] = pmod.launches - p0
    if (stats["grouped_launches_per_decode_step"], stats["proj_launches_per_decode_step"]) \
            != (len(MOE_BANKS) * L, MOE_PROJ * L):
        raise AssertionError(f"{label}: one decode step launched {gname} "
                             f"{stats['grouped_launches_per_decode_step']} and {pname} "
                             f"{stats['proj_launches_per_decode_step']} times")
    # K16's banks never split (fwd_plan); K13's projections as planned;
    # K1's and K4's on the pack entries' live blocks
    stats["merges_per_decode_step"] = gmod.fwd_merge_launches - m0
    want = (bs_merges(torch, cfg, {"params": engine.params, "pack": pack},
                      MOE_ENGINE["capacity"], "bs_fwd") if bs else
            L * planned_merges(torch, mm, cfg, engine.params["layers"][0], 16))
    print(f"{label}: one decode step: {stats['grouped_launches_per_decode_step']} "
          f"{gname} and {stats['proj_launches_per_decode_step']} {pname} launches, "
          f"{stats['merges_per_decode_step']} split merges (plans: {want}); "
          f"{merges_run} merges in the run")
    if stats["merges_per_decode_step"] != want:
        raise AssertionError(f"{label}: {stats['merges_per_decode_step']} merges in one "
                             f"decode step, the plans say {want}")
    stats["prefill_ms"] = 1e3 * stats["prefill_s"] / stats["prefills"]
    stats["decode_step_ms"] = 1e3 * stats["decode_step_s"]
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    stats["dead_slots_bit_identical"] = dead_slot_check(torch, cfg, engine.params, masks,
                                                        pack, label)
    rng = np.random.default_rng(7)
    probes = [rng.integers(0, cfg.vocab_size, 4) for _ in range(32)]
    stats["vs_dense"] = moe_vs_dense(torch, cfg, engine.params, masks, pack,
                                     [r.tokens for r in reqs], probes, label)

    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode, label)
    calls = []
    for layer in range(L):
        lay = engine.params["layers"][layer]["moe"]
        for b in MOE_BANKS:
            w = lay[b]["w"]
            x = torch.randn(w.shape[0], 16, w.shape[1], device="cuda")
            if bs:
                e = pack["layers"][layer]["moe"][b]["w"]
                calls.append((x, w, e["idx"], e["cnt"], e["nnz"]))
            else:
                calls.append((x, w, masks["layers"][layer]["moe"][b]["w"]))
    blk = cfg.sparse.kernel_block[2]
    run = (lambda: [bsm.grouped_block_sparse_matmul(x, w, i, c, bm=16, bn=blk, bk=blk, live=n)
                    for x, w, i, c, n in calls]) \
        if bs else (lambda: [mm.grouped_masked_matmul(*c, bm=16, bn=blk) for c in calls])
    stats["grouped_decode_step_ms"] = graph_ms(torch, run)
    share = stats["grouped_decode_step_ms"] / stats["decode_step_device_ms"]
    print(f"{label}: {gname} in one decode step: {len(calls)} launches, "
          f"{stats['grouped_decode_step_ms']:.2f} ms device time (CUDA-graph replay), "
          f"{share:.1%} of the step's device time; prefill {stats['prefill_ms']:.2f} ms "
          f"per admission, decode {stats['decode_step_ms']:.2f} ms/step host clock "
          f"(capacity 4), {stats['tok_per_s']:.2f} tok/s end to end, peak "
          f"{stats['peak_gib']:.1f} GiB; launches {launches}")
    cases = k4_cases(torch, timer, bsm, engine) if bs else k16_cases(torch, timer, mm, engine)
    return stats, launches, cases


# ---------------------------------------------------------------------------
# MoE training: qwen2-moe-a2.7b, the grouped backward kernels K5/K6
# (block-sparse) and K17/K18 (masked)
# ---------------------------------------------------------------------------

# 3 of 24 layers: 570.6 M parameters a layer, and the port's training holds
# ~31 bytes a parameter (f32 masters, Adam moments, gradients and their
# accumulator, masks, supersets); 3 layers and the 0.62 B of embedding and
# head come to ~67 GiB, 4 would pass 80 GB
MOE_TRAIN_LAYERS = 3
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH = 6, 8  # 8 x 1024 in the config's 4 microbatches
MOE_MASKED_STEPS, MOE_MASKED_BATCH = 6, 2  # 2 x 1024 in one microbatch
MOE_ROWS = (171, 16)  # a 2048-token microbatch's capacity C, and a small input


def moe_train_config(kernel):
    """qwen2-moe-a2.7b at its published widths, 3 layers deep, ERK 0.8,
    flash_tight, RigL with the Top-KAST superset (Δ = 10%) every
    ``DELTA_T`` steps; masked in one microbatch."""
    cfg = moe_config(kernel)
    cfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS, sparse=dataclasses.replace(
        cfg.sparse, method="rigl", delta_t=DELTA_T))
    return cfg if kernel == "block_sparse" else dataclasses.replace(cfg, microbatches=1)


def k5_k6_cases(torch, timer, bsm, state, cfg):
    """K5 (dx on the stacked CSR) and K6 (dw on the stacked superset CSC)
    against their plain versions on the training path's banks (60
    experts; wi as 2048 -> 1408, wo as 1408 -> 2048) at C = 171 rows (a
    2048-token microbatch's capacity, padded to the 128-row tile: 256) and
    16, f32 (the path's dtype) and bf16, on ``bank_topologies`` with
    supersets.  Bytes: g, the active weight blocks and dx once (K5); x, g
    and the dense dw once (K6); operations 2 C bk bn per active (K5) or
    superset (K6) block; the padded rows are zeros and count in neither.
    Library: torch.bmm on the C rows and the zero-filled dense bank (TF32
    off): g @ w^T and x^T @ g.  Both also under every candidate plan of the
    GEMM core (``fwd_sweep``, entries "bs_dx" and "bs_dw", on the live
    blocks: K5 the forward pack's, K6 the superset's), their f32 cases
    against a float64 product, and the merge of a split pick."""
    import numpy as np

    from repro_torch.kernels import masked_matmul as mm

    rng = np.random.default_rng(5)
    blk = cfg.sparse.kernel_block[2]
    lay = state["params"]["layers"][0]["moe"]
    pk = state["pack"]["layers"][0]["moe"]
    out = {"K5": [], "K6": [], "merge": [], "dx_merge": []}
    for bank in ("wi", "wo"):
        G, K, N = lay[bank]["w"].shape
        dead_ids, topo = bank_topologies(torch, rng, lay[bank]["w"], pk[bank]["w"], blk,
                                         superset=True)
        for tname, w32, e in topo:
            ridx, rcnt, bidx, bcnt = e["ridx"], e["rcnt"], e["bidx"], e["bcnt"]
            nnz, bnnz = int(rcnt.sum()), int(bcnt.sum())
            sup = bsm.unpack_block_mask(bidx, bcnt, K // blk)
            for dt in (torch.float32, torch.bfloat16):
                w = w32.to(dt)
                es = w.element_size()
                for C in MOE_ROWS:
                    bm, Mp, g_c, g = grouped_rows(torch, G, C, N, dt)
                    _, _, x_c, x = grouped_rows(torch, G, C, K, dt)
                    tag = f"{bank} {tname} {str(dt)[6:]} G={G} C={C}->{Mp} K={K} N={N}"

                    run_dx = lambda plan=None: bsm.grouped_block_sparse_dx(
                        g, w, ridx, rcnt, bm=bm, bn=blk, bk=blk, plan=plan, live=nnz)
                    want_dx = bsm.grouped_block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk)
                    absp_dx = bsm.grouped_block_sparse_dx_plain(
                        g.abs().float(), w.abs().float(), ridx, rcnt, blk, blk)

                    def check_dx(got=None):
                        got = run_dx() if got is None else got
                        res = _check_within(torch, f"K5 {tag}", got, want_dx, absp_dx, N, dt)
                        if "dead" in tname and got[dead_ids].float().abs().max().item() != 0:
                            raise AssertionError(f"K5 {tag}: a dead expert's dx is not zero")
                        return res

                    run_dw = lambda plan=None: bsm.grouped_block_sparse_dw(
                        x, g, bidx, bcnt, bn=blk, bk=blk, plan=plan, live=bnnz)

                    def check_dw(got=None):
                        got = run_dw() if got is None else got
                        want = bsm.grouped_block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk)
                        absp = bsm.grouped_block_sparse_dw_plain(
                            x.abs().float(), g.abs().float(), bidx, bcnt, blk, blk)
                        res = _check_within(torch, f"K6 {tag}", got, want, absp, Mp, dt)
                        outside = ~sup.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
                        if got[outside].float().abs().max().item() != 0:
                            raise AssertionError(f"K6 {tag}: dw outside the superset")
                        if "dead" in tname and got[dead_ids].float().abs().max().item() != 0:
                            raise AssertionError(f"K6 {tag}: a dead expert's dw is not zero")
                        return res

                    dx_tag = (f"{tag} blocks={nnz}/{G * (K // blk) * (N // blk)} "
                              f"row_width={ridx.shape[-1]}")
                    case = kernel_case(
                        torch, timer, "K5", dx_tag, run_dx,
                        lambda: bsm.grouped_block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk),
                        lambda: torch.bmm(g_c, w.transpose(1, 2)), check_dx,
                        es * (G * C * N + nnz * blk * blk + G * C * K)
                        + 4 * (ridx.numel() + rcnt.numel()),
                        2.0 * C * nnz * blk * blk, dt)
                    case.update(fwd_sweep(torch, timer, mm, run_dx, Mp, N, K, G, dt, case,
                                          entry="bs_dx", check=check_dx, bn_limit=blk,
                                          live=nnz, bk=blk))
                    del want_dx, absp_dx
                    if dt == torch.float32:
                        case["f64_rms_over_plain"] = bs_fwd_fidelity(
                            torch, bsm, f"K5 {dx_tag}", run_dx, g, w.transpose(1, 2), ridx,
                            rcnt, blk, case["plan"])
                    print("K5 plans", json.dumps(case))
                    out["K5"].append(case)
                    if case["plan"][2] > 1:
                        out["dx_merge"].append(merge_case(torch, timer, mm, case["plan"][2], G,
                                                          Mp, K, dt, dx_tag, entry="bs_dx"))
                    dw_tag = (f"{tag} superset blocks={bnnz}/{G * (K // blk) * (N // blk)} "
                              f"width={bidx.shape[-1]}")
                    case = kernel_case(
                        torch, timer, "K6", dw_tag, run_dw,
                        lambda: bsm.grouped_block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk),
                        lambda: torch.bmm(x_c.transpose(1, 2), g_c), check_dw,
                        es * (G * C * K + G * C * N + G * K * N)
                        + 4 * (bidx.numel() + bcnt.numel()),
                        2.0 * C * bnnz * blk * blk, dt)
                    case.update(fwd_sweep(torch, timer, mm, run_dw, K, Mp, N, G, dt, case,
                                          entry="bs_dw", check=check_dw, bn_limit=blk,
                                          live=bnnz))
                    case["dense_tflop_s"] = 2.0 * C * bnnz * blk * blk / case["ms"] / 1e9
                    if dt == torch.float32:
                        live = sup.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
                        case["f64_rms_over_plain"] = f64_fidelity(
                            torch, f"K6 {dw_tag}", run_dw,
                            lambda: bsm.grouped_block_sparse_dw_plain(x, g, bidx, bcnt, blk,
                                                                      blk),
                            lambda: torch.where(live, torch.bmm(x.double().transpose(1, 2),
                                                                g.double()), 0.0))
                        del live
                    print("K6 plans", json.dumps(case))
                    out["K6"].append(case)
                    if case["plan"][2] > 1:
                        out["merge"].append(bs_merge_case(torch, timer, bsm, case["plan"][2],
                                                          bidx, bcnt, K, N, dt, blk, dw_tag))
    return out


def k17_k18_cases(torch, timer, mm, state, cfg):
    """K17 (dx on the forward mask) and K18 (dw masked by the superset at
    the store) against their plain versions on layer 0's banks, elementwise
    ERK masks and Top-KAST supersets, at C = 171 (-> 256) and 16 rows, f32
    and bf16; both also under every candidate plan (``fwd_sweep``, each
    plan within the bound), with the split merge of a split pick, and in
    f32 against a float64 product (``f64_fidelity``).  Bytes: g, dx
    (K17) or x, g, dw (K18) once, and the weight and its 1-byte mask (K17)
    or the 1-byte superset (K18) once; operations: 2 C per active (K17) or
    superset (K18) weight; the padded rows count in neither.  Library on
    the C rows: torch.bmm on the pre-masked bank, and x^T @ g masked by the
    superset."""
    blk = cfg.sparse.kernel_block[2]
    out = {"K17": [], "K18": [], "dx_merge": [], "dw_merge": []}
    for bank in ("wi", "wo"):
        w32 = state["params"]["layers"][0]["moe"][bank]["w"]
        m = state["masks"]["layers"][0]["moe"][bank]["w"]
        b = state["bwd_masks"]["layers"][0]["moe"][bank]["w"]
        G, K, N = w32.shape
        nnz, bnnz = int(m.sum()), int(b.sum())
        for dt in (torch.float32, torch.bfloat16):
            w = w32.to(dt)
            wm = w * m
            es = w.element_size()
            for C in MOE_ROWS:
                bm, Mp, g_c, g = grouped_rows(torch, G, C, N, dt)
                _, _, x_c, x = grouped_rows(torch, G, C, K, dt)
                tag = (f"{bank} layer0 ERK {str(dt)[6:]} G={G} C={C}->{Mp} K={K} N={N} "
                       f"density={nnz / m.numel():.4f}")

                def check_dx():
                    got = mm.grouped_masked_dx(g, w, m, bm=bm, bk=blk)
                    want = mm.grouped_masked_dx_plain(g, w, m)
                    absp = mm.grouped_masked_dx_plain(g.abs().float(), w.abs().float(), m)
                    return _check_within(torch, f"K17 {tag}", got, want, absp, N, dt)

                def check_dw():
                    got = mm.grouped_masked_dw(x, g, b, bn=blk, bk=blk)
                    want = mm.grouped_masked_dw_plain(x, g, b)
                    absp = mm.grouped_masked_dw_plain(x.abs().float(), g.abs().float(), b)
                    return _check_within(torch, f"K18 {tag}", got, want, absp, Mp, dt)

                case = kernel_case(
                    torch, timer, "K17", tag,
                    lambda: mm.grouped_masked_dx(g, w, m, bm=bm, bk=blk),
                    lambda: mm.grouped_masked_dx_plain(g, w, m),
                    lambda: torch.bmm(g_c, wm.transpose(1, 2)), check_dx,
                    es * (G * C * N + G * C * K) + (es + 1) * G * K * N,
                    2.0 * C * nnz, dt)
                want = mm.grouped_masked_dx_plain(g, w, m)[:, :C]
                absp = mm.grouped_masked_dx_plain(g.abs().float(), w.abs().float(), m)[:, :C]
                case.update(fwd_sweep(
                    torch, timer, mm, lambda plan: mm.grouped_masked_dx(
                        g, w, m, bm=bm, bk=blk, plan=plan), Mp, N, K, G, dt, case, entry="dx",
                    check=lambda got: _check_within(torch, f"K17 {tag}", got[:, :C], want,
                                                    absp, N, dt),
                    bn_limit=blk))
                del want, absp
                print("K17 plans", json.dumps(case))
                out["K17"].append(case)
                if case["plan"][2] > 1:
                    out["dx_merge"].append(merge_case(torch, timer, mm, case["plan"][2], G, Mp,
                                                      K, dt, tag, entry="dx"))
                case = kernel_case(
                    torch, timer, "K18", f"{tag} superset density={bnnz / b.numel():.4f}",
                    lambda: mm.grouped_masked_dw(x, g, b, bn=blk, bk=blk),
                    lambda: mm.grouped_masked_dw_plain(x, g, b),
                    lambda: torch.bmm(x_c.transpose(1, 2), g_c) * b, check_dw,
                    es * (G * C * K + G * C * N + G * K * N) + G * K * N,
                    2.0 * C * bnnz, dt)
                want = mm.grouped_masked_dw_plain(x, g, b)
                absp = mm.grouped_masked_dw_plain(x.abs().float(), g.abs().float(), b)
                case.update(fwd_sweep(
                    torch, timer, mm, lambda plan: mm.grouped_masked_dw(
                        x, g, b, bn=blk, bk=blk, plan=plan), K, Mp, N, G, dt, case,
                    entry="dw", check=lambda got: _check_within(torch, f"K18 {tag}", got, want,
                                                                absp, Mp, dt),
                    bn_limit=blk))
                case["dense_tflop_s"] = 2.0 * C * G * K * N / case["ms"] / 1e9
                del want, absp
                if dt == torch.float32:
                    case["f64_rms_over_plain"] = f64_fidelity(
                        torch, f"K18 {tag}", lambda: mm.grouped_masked_dw(x, g, b, bn=blk, bk=blk),
                        lambda: mm.grouped_masked_dw_plain(x, g, b),
                        lambda: torch.bmm(x.double().transpose(1, 2), g.double()) * b)
                print("K18 plans", json.dumps(case))
                out["K18"].append(case)
                if case["plan"][2] > 1:
                    out["dw_merge"].append(merge_case(torch, timer, mm, case["plan"][2], G, K,
                                                      N, dt, tag, entry="dw", mask=b))
    return out


def grouped_trace_ms(path, n_groups):
    """Device ms of the grouped kernels (grid dim z = the bank's group
    count) in a profiler chrome trace, or None when the trace carries no
    grid dims."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    if not kern or not all("grid" in e.get("args", {}) for e in kern):
        return None
    return sum(e["dur"] for e in kern if e["args"]["grid"][-1] == n_groups
               and ("block_sparse" in e["name"] or "masked" in e["name"])) / 1e3


def moe_train(torch, timer, bsm, mm, fa, kernel):
    """Train qwen2-moe-a2.7b (full width, 3 of 24 layers, ERK 0.8,
    flash_tight, RigL with the Top-KAST superset, Adam, warmup-cosine, seed
    0) under ``kernel``: block_sparse (128x128 blocks; 8 x 1024 tokens in 4
    microbatches) or masked (2 x 1024 in one microbatch), 6 steps, a
    drop/grow at step 2.  First the grouped backward kernels against their
    plain versions on the path's own layer 0 (K5/K6 or K17/K18) and the
    step-0 loss and gradients against the plain dense path with routing
    pinned; then ``train_loop`` with every launch counter set to 0 just
    before it: finite losses, the exact launches of every kernel in every
    step, and after the update the block (or weight) counts of every layer
    kept, B ⊇ A, the pack (or carrier) fresh and valid.  Reports wall and
    device time per step, tokens per second, the peak memory of each step
    (the update step's apart), the busy share of the profiled last step
    and the grouped kernels' share of it."""
    from repro_torch.core.masks import block_mask_of, tree_paths
    from repro_torch.core.pack import pack_entries, pack_mismatch, validate_pack
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    bs = kernel == "block_sparse"
    label = f"moe train {kernel}"
    cfg = moe_train_config(kernel)
    steps, batch = (MOE_TRAIN_STEPS, MOE_TRAIN_BATCH) if bs else \
        (MOE_MASKED_STEPS, MOE_MASKED_BATCH)
    # the run's own initial weights, masks, supersets and packs (seed 0;
    # the draws do not depend on the optimizer, so sgd keeps this copy small)
    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    cases = (k5_k6_cases(torch, timer, bsm, state, cfg) if bs
             else k17_k18_cases(torch, timer, mm, state, cfg))
    # the split merges a microbatch: K13's (K16's banks never split,
    # fwd_plan), and K14's and K17's
    tokens, layer0 = batch * TRAIN_SEQ // cfg.microbatches, state["params"]["layers"][0]
    merges = 0 if bs else cfg.n_layers * planned_merges(torch, mm, cfg, layer0, tokens)
    dx_merges = 0 if bs else cfg.n_layers * (
        planned_merges(torch, mm, cfg, layer0, tokens, "dx")
        + bank_merges(torch, mm, cfg, layer0, tokens))
    dw_merges = 0 if bs else cfg.n_layers * (
        planned_merges(torch, mm, cfg, layer0, tokens, "dw")
        + bank_merges(torch, mm, cfg, layer0, tokens, "dw"))
    del layer0
    # K1's and K4's, K2's and K5's, and K3's and K6's split merges on the
    # pack a step runs on, (a microbatch's, the full batch's); the initial
    # pack's here
    bs_tokens = (tokens, batch * TRAIN_SEQ)
    bs_count = lambda st: {e: tuple(bs_merges(torch, cfg, st, n, e) if bs else 0
                                    for n in bs_tokens) for e in BS_ENTRIES}
    bs_merges0 = bs_count(state)
    dense_check = train_dense_check(
        torch, cfg, state, label=label,
        names=("layers/0/moe/wi/w", "layers/0/moe/shared/wi/w", "layers/0/moe/router/w"))
    del state
    torch.cuda.empty_cache()

    counters = (("block_sparse_fwd", bsm, "launches"), ("block_sparse_dx", bsm, "dx_launches"),
                ("block_sparse_dw", bsm, "dw_launches"),
                ("grouped_block_sparse_fwd", bsm, "g_launches"),
                ("grouped_block_sparse_dx", bsm, "gdx_launches"),
                ("grouped_block_sparse_dw", bsm, "gdw_launches"),
                ("masked_fwd", mm, "launches"), ("masked_dx", mm, "dx_launches"),
                ("masked_dw", mm, "dw_launches"), ("grouped_masked_fwd", mm, "g_launches"),
                ("grouped_masked_dx", mm, "gdx_launches"),
                ("grouped_masked_dw", mm, "gdw_launches"),
                ("masked_fwd_merge", mm, "fwd_merge_launches"),
                ("masked_dx_merge", mm, "dx_merge_launches"),
                ("masked_dw_merge", mm, "dw_merge_launches"),
                ("block_sparse_fwd_merge", bsm, "fwd_merge_launches"),
                ("block_sparse_dx_merge", bsm, "dx_merge_launches"),
                ("block_sparse_dw_merge", bsm, "dw_merge_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"))
    read = lambda: {n: getattr(mod, a) for n, mod, a in counters}
    L, B = cfg.n_layers, len(MOE_BANKS)
    fam, gfam = ("block_sparse", "grouped_block_sparse") if bs else ("masked", "grouped_masked")

    def expected(is_update, n_bs):
        # remat reruns each block's forward in the backward: the forward
        # kernels launch twice per microbatch; the update step's gradient
        # is one pass over the full batch
        mb = 1 if is_update else cfg.microbatches
        per = lambda k: n_bs[k][1] if is_update else n_bs[k][0] * mb
        e = {n: 0 for n, _, _ in counters}
        e.update({f"{fam}_fwd": 2 * MOE_PROJ * L * mb, f"{fam}_dx": MOE_PROJ * L * mb,
                  f"{fam}_dw": MOE_PROJ * L * mb, f"{gfam}_fwd": 2 * B * L * mb,
                  f"{gfam}_dx": B * L * mb, f"{gfam}_dw": B * L * mb,
                  "flash_fwd": 2 * L * mb, "flash_dq": L * mb, "flash_dkv": L * mb,
                  "masked_fwd_merge": 2 * merges * mb, "masked_dx_merge": dx_merges * mb,
                  "masked_dw_merge": dw_merges * mb,
                  "block_sparse_fwd_merge": 2 * per("bs_fwd"),
                  "block_sparse_dx_merge": per("bs_dx"), "block_sparse_dw_merge": per("bs_dw")})
        return e

    log, seen = [], {"counts": None, "t": None, "ev": None, "prof": None, "units": None,
                     "bs_merges": bs_merges0}

    def units(masks):
        """Active blocks (block_sparse) or weights (masked) of every leaf."""
        return {n: (block_mask_of(m, cfg.sparse.block_shape) if bs else m)
                for n, m in tree_paths(masks).items()}

    def on_step(step, is_update, state, m):
        torch.cuda.synchronize()
        t, ev = time.perf_counter(), torch.cuda.Event(enable_timing=True)
        ev.record()
        counts = read()
        prev = seen["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if seen["t"] is not None:
            rec["wall_s"] = t - seen["t"]
            rec["device_span_ms"] = seen["ev"].elapsed_time(ev)
        # the step ran on the pack it left unless it updated the topology
        want = expected(is_update, seen["bs_merges"] if is_update else bs_count(state))
        if rec["launches"] != want:
            raise AssertionError(f"{label} step {step}: launches {rec['launches']}, "
                                 f"expected {want}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{label} step {step}: loss {rec['loss']}")
        seen["bs_merges"] = bs_count(state)
        if step == 1:
            seen["units"] = {n: u.cpu() for n, u in units(state["masks"]).items()}
        if step == steps - 1:  # the last step, a plain one after the update
            seen["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            seen["prof"].__enter__()
        elif step == steps:
            seen["prof"].__exit__(None, None, None)
        print(f"{label}:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen.update(counts=counts, t=time.perf_counter(),
                    ev=torch.cuda.Event(enable_timing=True))
        seen["ev"].record()

    for _, mod, a in counters:
        setattr(mod, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = train_loop(cfg, steps=steps, batch=batch, seq=TRAIN_SEQ,
                          workdir=str(ROOT / "chiprun_out" / f"moe_train_{kernel}"),
                          device="cuda", on_step=on_step, log_every=steps, ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()

    after, bwd = units(state["masks"]), units(state["bwd_masks"])
    moved = 0
    for n, u in after.items():
        before = seen["units"][n]
        if int(u.sum()) != int(before.sum()):
            raise AssertionError(f"{label}: {n}: {int(before.sum())} active units before "
                                 f"the update, {int(u.sum())} after")
        if (u & ~bwd[n]).any():
            raise AssertionError(f"{label}: {n}: the superset does not contain the mask")
        moved += int((u.cpu() & ~before).sum())
    if moved == 0:
        raise AssertionError(f"{label}: the drop/grow moved nothing")
    if bs:
        validate_pack(state["pack"], where="chip_smoke moe")
        stale = int(pack_mismatch(state["masks"], state["pack"], cfg.sparse.block_shape,
                                  bwd_masks=state["bwd_masks"]))
        if stale:
            raise AssertionError(f"{label}: pack stale after the update: {stale} blocks")
    else:
        carried = dict(pack_entries(state["pack"]))
        bw = tree_paths(state["bwd_masks"])
        if sorted(carried) != sorted(bw) or any(carried[n]["bwd_mask"] is not bw[n]
                                                for n in bw):
            raise AssertionError(f"{label}: the carrier does not hold the refreshed superset")
        validate_pack(state["pack"], where="chip_smoke moe masked")
    del state
    torch.cuda.empty_cache()

    steady = [r for r in log if "wall_s" in r and not r["update"] and r["step"] != steps]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    from torch.autograd import DeviceType

    prof = [e for e in seen["prof"].key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    busy_ms = sum(dev_ms(e) for e in prof)
    trace = ROOT / "chiprun_out" / f"moe_train_{kernel}_trace.json"
    seen["prof"].export_chrome_trace(str(trace))
    grouped_ms = grouped_trace_ms(trace, cfg.n_experts)
    (ROOT / "chiprun_out" / f"moe_train_{kernel}_profile.txt").write_text(
        seen["prof"].key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    profiled = log[-1]
    upd = [r for r in log if r["update"]]
    stats = {
        "layers": L, "steps": steps, "tokens_per_step": batch * TRAIN_SEQ,
        "microbatches": cfg.microbatches, "total_s": total_s,
        "mean_train_step_wall_s": wall, "steady_steps": [r["step"] for r in steady],
        "mean_train_step_device_span_ms": sum(r["device_span_ms"] for r in steady) / len(steady),
        "tok_per_s": batch * TRAIN_SEQ / wall,
        "update_step_wall_s": [r.get("wall_s") for r in upd],
        "steady_step_peak_gib": max(r["peak_gib"] for r in steady),
        "update_step_peak_gib": max(r["peak_gib"] for r in upd),
        "first_step_peak_gib": log[0]["peak_gib"],
        "profiled_step_wall_s": profiled["wall_s"],
        "profiled_step_device_busy_ms": busy_ms or None,
        "profiled_step_busy_share": busy_ms / 1e3 / profiled["wall_s"] if busy_ms else None,
        "profiled_step_grouped_ms": grouped_ms,
        "profiled_step_grouped_share": grouped_ms / busy_ms if grouped_ms and busy_ms else None,
        "profiled_step_block_sparse_ms": block_sparse_ms(prof),
        "profiled_step_top": [(e.key, dev_ms(e), e.count) for e in
                              sorted(prof, key=dev_ms, reverse=True)[:25]],
        "losses": [r["loss"] for r in log], "launches_per_step": [r["launches"] for r in log],
        "units_moved": moved, "step0_vs_dense": dense_check,
    }
    gshare = stats["profiled_step_grouped_share"]
    print(f"{label}: qwen2-moe-a2.7b {L} of 24 layers, {steps} steps of {batch} x "
          f"{TRAIN_SEQ} tokens in {total_s:.1f} s; train step {wall:.3f} s wall (mean of "
          f"{len(steady)}) = {stats['tok_per_s']:.0f} tok/s, device span "
          f"{stats['mean_train_step_device_span_ms']:.1f} ms; peak "
          f"{stats['steady_step_peak_gib']:.1f} GiB steady, "
          f"{stats['update_step_peak_gib']:.1f} GiB in the update step; profiled step "
          f"busy {busy_ms:.1f} ms of {profiled['wall_s']:.3f} s, grouped kernels "
          f"{'not measured' if gshare is None else f'{gshare:.1%}'} of the busy time; "
          f"{moved} {'blocks' if bs else 'weights'} moved by the drop/grow; "
          f"launches {launches}")
    return stats, launches, cases


def k8_cases(torch, timer, bsm, state, cfg):
    """K8 against its plain version on the fused block-sparse path's banks
    (60 experts; wi as 2048 -> 1408, wo as 1408 -> 2048) at C = 171 rows
    (-> 256) and 16, f32 (the path's dtype) and bf16, sr off and on, bf16
    mom, on ``bank_topologies`` with supersets (layer 0's ERK banks, a
    uniform 20% mask, two experts with no block); checks in
    ``fused_checks``; each case also under every candidate plan
    (``bs_fused_sweep``, with the f32 cases' float64 fidelity).  Bytes on
    the C rows: x and g once, w and mom read
    and m_new written on the superset blocks, the zero fill of the rest of
    the dense (G, K, N) output; operations 2 C bk bn per superset block.
    Yardstick: K6 then the SGD update.  Returns (the cases, the fused
    merges of split picks)."""
    import numpy as np
    from repro_torch.kernels import masked_matmul as mm

    rng = np.random.default_rng(6)
    blk = cfg.sparse.kernel_block[2]
    lay, pk = state["params"]["layers"][0]["moe"], state["pack"]["layers"][0]["moe"]
    kw = dict(mu=FUSED_MU, wd=FUSED_WD)
    out, merges = [], []
    for bank in ("wi", "wo"):
        G, K, N = lay[bank]["w"].shape
        dead_ids, topo = bank_topologies(torch, rng, lay[bank]["w"], pk[bank]["w"], blk,
                                         superset=True)
        for tname, w32, e in topo:
            bidx, bcnt = e["bidx"], e["bcnt"]
            bnnz = int(bcnt.sum())
            sup = bsm.unpack_block_mask(bidx, bcnt, K // blk)
            sup = sup.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
            mom = (0.01 * torch.randn(G, K, N, device="cuda") * sup).to(torch.bfloat16)
            for dt in (torch.float32, torch.bfloat16):
                w = w32.to(dt)
                es = w.element_size()
                for C in MOE_ROWS:
                    bm, Mp, g_c, g = grouped_rows(torch, G, C, N, dt)
                    _, _, x_c, x = grouped_rows(torch, G, C, K, dt)
                    xt = x.float().transpose(1, 2)
                    acc, absp = torch.bmm(xt, g.float()), torch.bmm(xt.abs(), g.float().abs())
                    for sr in (False, True):
                        tag = (f"K8 {bank} {tname} {str(dt)[6:]} G={G} C={C}->{Mp} K={K} "
                               f"N={N} superset blocks={bnnz}/{G * (K // blk) * (N // blk)} "
                               f"width={bidx.shape[-1]} sr={sr}")
                        run = lambda: bsm.grouped_block_sparse_dw_fused(
                            x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=sr, bn=blk, bk=blk,
                            live=bnnz, **kw)
                        plain = lambda: bsm.grouped_block_sparse_dw_fused_plain(
                            x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=sr, bk=blk, bn=blk, **kw)
                        raw = None if not sr else lambda: bsm.grouped_block_sparse_dw_fused(
                            x, g, bidx, bcnt, w, mom, FUSED_SEED, sr=False, bn=blk, bk=blk,
                            out_dtype=torch.float32, live=bnnz, **kw)
                        unfused = lambda: (FUSED_MU * mom.float() + bsm.grouped_block_sparse_dw(
                            x, g, bidx, bcnt, bn=blk, bk=blk, live=bnnz).float()
                            + FUSED_WD * w.float()).to(dt)
                        bound = lambda want: mm.fused_error_bound(
                            want, absp, Mp, FUSED_MU, FUSED_WD, mom, w, acc, sup)

                        def check():
                            res = fused_checks(torch, tag, run, plain, raw,
                                               lambda: mm._gid(K, N, "cuda", G=G), sup, bound)
                            if "dead" in tname and run()[dead_ids].float().abs().max().item():
                                raise AssertionError(f"{tag}: a group with no block is not zero")
                            return res

                        out.append(fused_case(
                            torch, timer, "K8", tag, run, plain, unfused, check,
                            es * (G * C * K + G * C * N + G * K * N) + (es + 2) * bnnz * blk * blk
                            + 4 * (bidx.numel() + bcnt.numel()),
                            2.0 * C * bnnz * blk * blk, dt))
                        merges += bs_fused_sweep(torch, timer, bsm, out[-1], x, g, bidx, bcnt,
                                                 w, mom, sr, blk, sup, absp, acc, tag)
    return out, merges


def k20_cases(torch, timer, bsm, mm, state, cfg):
    """K20 against its plain version on the fused masked path's banks:
    layer 0's elementwise ERK masks' Top-KAST supersets, wi and wo, C = 171
    (-> 256) and 16 rows, f32 and bf16, sr off and on, bf16 mom; checks in
    ``fused_checks``; sr off also under every candidate plan, with the f32
    cases' float64 fidelity (``fused_sweep``).  Bytes on the C rows as
    K19's: x and g once, and per weight its 1-byte mask, w, mom and m_new;
    operations 2 C per superset weight.  Yardstick: K18 then the SGD
    update.  Returns (the cases, the fused merges of split picks)."""
    blk = cfg.sparse.kernel_block[2]
    kw = dict(mu=FUSED_MU, wd=FUSED_WD)
    out, merges = [], []
    for bank in ("wi", "wo"):
        w32 = state["params"]["layers"][0]["moe"][bank]["w"]
        b = state["bwd_masks"]["layers"][0]["moe"][bank]["w"]
        G, K, N = w32.shape
        bnnz = int(b.sum())
        mom = (0.01 * torch.randn(G, K, N, device="cuda") * b).to(torch.bfloat16)
        for dt in (torch.float32, torch.bfloat16):
            w = w32.to(dt)
            es = w.element_size()
            for C in MOE_ROWS:
                bm, Mp, g_c, g = grouped_rows(torch, G, C, N, dt)
                _, _, x_c, x = grouped_rows(torch, G, C, K, dt)
                xt = x.float().transpose(1, 2)
                acc, absp = torch.bmm(xt, g.float()), torch.bmm(xt.abs(), g.float().abs())
                for sr in (False, True):
                    tag = (f"K20 {bank} layer0 ERK superset {str(dt)[6:]} G={G} C={C}->{Mp} "
                           f"K={K} N={N} density={bnnz / b.numel():.4f} sr={sr}")
                    run = lambda: mm.grouped_masked_dw_fused(
                        x, g, b, w, mom, FUSED_SEED, sr=sr, bn=blk, bk=blk, **kw)
                    plain = lambda: mm.grouped_masked_dw_fused_plain(
                        x, g, b, w, mom, FUSED_SEED, sr=sr, **kw)
                    raw = None if not sr else lambda: mm.grouped_masked_dw_fused(
                        x, g, b, w, mom, FUSED_SEED, sr=False, bn=blk, bk=blk,
                        out_dtype=torch.float32, **kw)
                    unfused = lambda: (FUSED_MU * mom.float() + mm.grouped_masked_dw(
                        x, g, b, bn=blk, bk=blk).float() + FUSED_WD * w.float()).to(dt)
                    bound = lambda want: mm.fused_error_bound(
                        want, absp, Mp, FUSED_MU, FUSED_WD, mom, w, acc, b)
                    check = lambda: fused_checks(torch, tag, run, plain, raw,
                                                 lambda: mm._gid(K, N, "cuda", G=G), b, bound)
                    out.append(fused_case(
                        torch, timer, "K20", tag, run, plain, unfused, check,
                        es * (G * C * K + G * C * N) + G * K * N * (1 + 2 * es + 2),
                        2.0 * C * bnnz, dt))
                    if not sr:
                        merges += fused_sweep(
                            torch, timer, mm, out[-1], x, g, b, w, mom, FUSED_SEED, acc, absp,
                            dt, tag, bn=blk, bk=blk)
    return out, merges


def k8_equals_k20(torch, bsm, mm, state, cfg):
    """K8 and K20 on one block-aligned mask, the same inputs: layer 0's wi
    bank superset (the block-sparse path's masks are block-aligned), f32, C
    = 171 -> 256 rows, bf16 mom.  Both run one GEMM-core walk with the same
    momentum epilogue, so on the same tile and split they agree bit for
    bit: each at its own pick (qwen2-moe's picks are both unsplit 128 x
    128 here; where they differ both are forced to K20's), sr off (f32
    m_new) and on, every element of the support bit for bit, both zero off
    it (K20 multiplies by the mask byte, so its zeros may carry a sign;
    K8's are +0.0).  Each is also held, sr off, within
    ``mm.fused_error_bound`` of the same plain version.  Returns the
    comparison."""
    blk = cfg.sparse.kernel_block[2]
    w = state["params"]["layers"][0]["moe"]["wi"]["w"]
    b = state["bwd_masks"]["layers"][0]["moe"]["wi"]["w"]
    e = state["pack"]["layers"][0]["moe"]["wi"]["w"]
    G, K, N = w.shape
    _, Mp, _, g = grouped_rows(torch, G, MOE_ROWS[0], N, w.dtype)
    _, _, _, x = grouped_rows(torch, G, MOE_ROWS[0], K, w.dtype)
    mom = (0.01 * torch.randn(G, K, N, device="cuda") * b).to(torch.bfloat16)
    bnnz, dev = int(e["bcnt"].sum()), torch.cuda.current_device()
    kw = dict(mu=FUSED_MU, wd=FUSED_WD, bn=blk, bk=blk)
    picks = {"K8": list(bsm._dw_plan_for(Mp, K, N, G, w.dtype, blk, bnnz, dev, mom.dtype,
                                         w.dtype)),
             "K20": list(mm._fwd_plan_for(K, Mp, N, G, w.dtype, blk, dev, "dw_fused",
                                          mom.dtype, w.dtype))}
    plan = None if picks["K8"] == picks["K20"] else tuple(picks["K20"])
    runs = {"K8": lambda sr, o=None: bsm.grouped_block_sparse_dw_fused(
                x, g, e["bidx"], e["bcnt"], w, mom, FUSED_SEED, sr=sr, out_dtype=o, plan=plan,
                live=bnnz, **kw),
            "K20": lambda sr, o=None: mm.grouped_masked_dw_fused(
                x, g, b, w, mom, FUSED_SEED, sr=sr, out_dtype=o, plan=plan, **kw)}
    want = mm.grouped_masked_dw_fused_plain(x, g, b, w, mom, FUSED_SEED, mu=FUSED_MU,
                                            wd=FUSED_WD, sr=False)
    xt = x.float().transpose(1, 2)
    bound = mm.fused_error_bound(want, torch.bmm(xt.abs(), g.float().abs()), Mp, FUSED_MU,
                                 FUSED_WD, mom, w, torch.bmm(xt, g.float()), b)
    res = {"picks": picks, "forced": None if plan is None else list(plan)}
    out = {}
    for name, run in runs.items():
        ok, ratio, _ = within(torch, run(False), want, bound)
        out[name] = {sr: run(sr, torch.float32 if not sr else None) for sr in (False, True)}
        res[name] = {"within_bound": ok, "err_over_tol": ratio}
    for sr in (False, True):
        k8, k20 = out["K8"][sr].float(), out["K20"][sr].float()
        res[f"bit_for_bit_sr_{sr}"] = torch.equal(k8[b].view(torch.int32),
                                                  k20[b].view(torch.int32))
        res[f"zero_off_support_sr_{sr}"] = not (k8[~b].any() or k20[~b].any()
                                                or torch.signbit(k8[~b]).any())
    res["max_abs_k8_minus_k20"] = (out["K8"][False] - out["K20"][False]).abs().max().item()
    res["nonzero"] = int((out["K8"][True] != 0).sum())
    print("moe fused train: K8 and K20 on layer 0's wi superset:", json.dumps(res))
    if not (all(res[k]["within_bound"] for k in runs)
            and all(res[f"{c}_sr_{sr}"] for c in ("bit_for_bit", "zero_off_support")
                    for sr in (False, True))):
        raise AssertionError(f"K8 and K20 on a block-aligned mask: {res}")
    return res


def moe_fused_train(torch, timer, bsm, mm, fa, kernel):
    """Train qwen2-moe-a2.7b (full width, 3 of 24 layers, ERK 0.8,
    flash_tight, RigL with the Top-KAST superset) with the fused SGD
    epilogue under ``kernel``, 2 x 1024 tokens in one microbatch (C = 171):
    first K8 (block_sparse; and K8 against K20 bit for bit) or K20 (masked)
    against its plain version on the path's own layer 0, and K7
    (``k7_cases``) or K19 (``k19_moe_cases``) on its 2-D projections there
    (attn.wq in bf16, the shared MLP in f32, 2048 rows), then 2 fused steps
    beside unfused ones with routing pinned (``fused_steps``): exactly 42
    K1, 21 K2, 21 K7, 18 K4, 9 K5, 9 K8 (and the planned split merges of
    K1/K4 and K2/K5), no K3 or K6 (block_sparse), or 42
    K13, 21 K14, 21 K19, 18 K16, 9 K17, 9 K20, no K15 or K18 (masked), and
    6/3/3 K9-K11 per fused step, and the planned fused merges of K7/K8
    (block_sparse) or K19/K20 (masked).  Returns (stats, launches, the bank
    kernel's cases, the 2-D kernel's cases, the fused merges' cases)."""
    from repro_torch.training.steps import init_train_state

    bs = kernel == "block_sparse"
    cfg = moe_train_config(kernel)
    cfg = dataclasses.replace(cfg, microbatches=1, sparse=dataclasses.replace(
        cfg.sparse, fused_epilogue=True))
    state, _ = init_train_state(cfg, fused_opt()[0], seed=0, device="cuda")
    merges = []
    if bs:
        cases, merges = k8_cases(torch, timer, bsm, state, cfg)
        k8_k20 = k8_equals_k20(torch, bsm, mm, state, cfg)
        cases_2d, merges_2d = k7_cases(torch, timer, bsm, state, cfg, proj=MOE_FUSED_PROJ,
                                       rows=(2048,), moms=("bfloat16",), model="qwen2-moe")
        merges += merges_2d
    else:
        cases, merges = k20_cases(torch, timer, bsm, mm, state, cfg)
        cases_2d, merges_2d = k19_moe_cases(torch, timer, mm, state, cfg)
        merges += merges_2d
    mod, fam = (bsm, "block_sparse") if bs else (mm, "masked")
    counters = ((f"{fam}_fwd", mod, "launches"), (f"{fam}_dx", mod, "dx_launches"),
                (f"{fam}_dw", mod, "dw_launches"), (f"{fam}_dw_fused", mod, "fused_launches"),
                (f"grouped_{fam}_fwd", mod, "g_launches"),
                (f"grouped_{fam}_dx", mod, "gdx_launches"),
                (f"grouped_{fam}_dw", mod, "gdw_launches"),
                (f"grouped_{fam}_dw_fused", mod, "g_fused_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"))
    L, B = cfg.n_layers, len(MOE_BANKS)
    dx_merge, dw_merge = {}, None
    if bs:  # K1's and K4's planned split merges (twice: remat) and K2's and
        # K5's in both steps, K3's and K6's in the unfused step only, K7's
        # and K8's in the fused step only
        tokens = MASKED_BATCH * TRAIN_SEQ
        counters += (("block_sparse_fwd_merge", bsm, "fwd_merge_launches"),
                     ("block_sparse_dx_merge", bsm, "dx_merge_launches"),
                     ("block_sparse_dw_merge", bsm, "dw_merge_launches"),
                     ("block_sparse_dw_fused_merge", bsm, "dw_fused_merge_launches"))
        dx_merge = {"block_sparse_fwd_merge": 2 * bs_merges(torch, cfg, state, tokens,
                                                            "bs_fwd"),
                    "block_sparse_dx_merge": bs_merges(torch, cfg, state, tokens, "bs_dx"),
                    "block_sparse_dw_merge": 0,
                    "block_sparse_dw_fused_merge": bs_merges(torch, cfg, state, tokens,
                                                             "bs_dw_fused")}
        dw_merge = {"block_sparse_dw_merge": bs_merges(torch, cfg, state, tokens),
                    "block_sparse_dw_fused_merge": 0}
    else:  # K14's and K17's planned split merges (one microbatch), K19's and
        # K20's in the fused step only, K15's and K18's in the unfused step only
        tokens, layer0 = MASKED_BATCH * TRAIN_SEQ, state["params"]["layers"][0]
        counters += (("masked_dx_merge", mm, "dx_merge_launches"),
                     ("masked_dw_merge", mm, "dw_merge_launches"),
                     ("masked_dw_fused_merge", mm, "dw_fused_merge_launches"))
        n = {e: L * (planned_merges(torch, mm, cfg, layer0, tokens, e)
                     + bank_merges(torch, mm, cfg, layer0, tokens, e))
             for e in ("dx", "dw", "dw_fused")}
        dx_merge = {"masked_dx_merge": n["dx"], "masked_dw_merge": 0,
                    "masked_dw_fused_merge": n["dw_fused"]}
        dw_merge = {"masked_dw_merge": n["dw"], "masked_dw_fused_merge": 0}
        del layer0
    # remat reruns each block's forward in the backward: the forward
    # kernels launch twice
    want = {f"{fam}_fwd": 2 * MOE_PROJ * L, f"{fam}_dx": MOE_PROJ * L, f"{fam}_dw": 0,
            f"{fam}_dw_fused": MOE_PROJ * L, f"grouped_{fam}_fwd": 2 * B * L,
            f"grouped_{fam}_dx": B * L, f"grouped_{fam}_dw": 0,
            f"grouped_{fam}_dw_fused": B * L, "flash_fwd": 2 * L, "flash_dq": L,
            "flash_dkv": L, **dx_merge}
    stats, launches = fused_steps(torch, cfg, state, counters, want,
                                  f"moe fused train {kernel}", pin_routing=True,
                                  unfused_merges=dw_merge)
    stats["layers"] = L
    stats["peak_gib"] = max(r[f"{k}_peak_gib"] for r in stats["steps"]
                            for k in ("fused", "unfused"))
    if bs:
        stats["k8_vs_k20"] = k8_k20
    return stats, launches, cases, cases_2d, merges


# ---------------------------------------------------------------------------
# K21: the |x| histogram behind ops.topk_threshold
# ---------------------------------------------------------------------------

def erk_sparsity(cfg, leaf="mlp/wi"):
    """One layer's ERK sparsity at 0.8 from the config's widths alone: the
    seven projections of every layer as ``LayerSpec``s (the solver needs
    shapes, not weights; ERK over identical layers does not depend on the
    depth)."""
    from repro_torch.core.distributions import LayerSpec, get_distribution

    d, q, kv, ff = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, \
        cfg.d_ff
    shapes = {"attn/wq": (d, q), "attn/wk": (d, kv), "attn/wv": (d, kv), "attn/wo": (q, d),
              "mlp/wi": (d, ff), "mlp/wg": (d, ff), "mlp/wo": (ff, d)}
    specs = [LayerSpec(f"layers/{i}/{k}/w", s) for i in range(cfg.n_layers)
             for k, s in shapes.items()]
    return get_distribution("erk", specs, 0.8, dense_first=False)[f"layers/0/{leaf}/w"]


TOPK_FRACTIONS = (0.2, 0.01)


def topk_inputs(torch):
    """(label, x) of the K21 cases: danube's layers/0/mlp/wi/w (2560 x 6912)
    from its seeded init, dense, under a mask at its ERK density, and in
    bf16; a seeded matrix of mistral-large's MLP shape (12288 x 28672, 352 M
    elements), dense and masked at its ERK density.  The masks are
    Bernoulli at the density (the histogram sees the zeros' skew, not the
    pattern)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import truncated_normal_init

    for arch in ("h2o-danube-1.8b", "mistral-large-123b"):
        cfg = get_config(arch)
        s = erk_sparsity(cfg)
        gen = torch.Generator(device="cuda").manual_seed(21)
        w = truncated_normal_init(gen, (cfg.d_model, cfg.d_ff), 1.0)
        tag = f"{arch} mlp.wi {cfg.d_model}x{cfg.d_ff}"
        yield f"{tag} f32 dense", w
        if arch == "h2o-danube-1.8b":
            yield f"{tag} bf16 dense", w.to(torch.bfloat16)
        keep = torch.rand(w.shape, generator=gen, device="cuda") < (1.0 - s)
        w.mul_(keep)
        del keep
        yield f"{tag} f32 masked (ERK density {1 - s:.4f})", w
        del w
        torch.cuda.empty_cache()


def k21_case(torch, timer, tk, label, x, hi):
    """K21 on one input against its plain version (the integer counts equal
    in every bin, summing to n), timed beside its byte bound, the plain
    version and the library yardstick ``torch.histc`` of |x| (time only:
    its bin edges differ; a bf16 x is cast to f32 first, histc takes no
    bf16)."""
    n = x.numel()
    got, want = tk.histogram_counts(x, hi), tk.histogram_counts_plain(x, hi)
    err = (got - want).abs().max().item()
    if err or int(got.sum()) != n:
        raise AssertionError(f"K21 {label}: {int((got != want).sum())} bins differ from the "
                             f"plain version, sum {int(got.sum())} of {n}")
    hi_f = float(hi)
    b_ms, by = bound_ms(n * x.element_size() + 8 * tk.N_BINS, 0.0)
    case = {"case": f"{label} n={n}", "max_abs_err": err,
            "bin0": int(got[0]), "bin511": int(got[-1]),
            "ms": timer(lambda: tk.histogram_counts(x, hi)),
            "plain_ms": timer(lambda: tk.histogram_counts_plain(x, hi), reps=3),
            "library_ms": timer(lambda: torch.histc(
                x.abs() if x.dtype == torch.float32 else x.float().abs(),
                bins=tk.N_BINS, min=0.0, max=hi_f)),
            "bound_ms": b_ms, "bound_by": by}
    print("K21", json.dumps(case))
    return case


def topk_cases(torch, timer, tk, ops):
    """K21 and ``ops.topk_threshold`` on every input of ``topk_inputs``.
    Per input: K21 on the first pass's input (``k21_case``).  Per k (20% and
    1% of n): the threshold through K21 bit for bit against the plain path
    (both histograms of each run recorded and held bin for bin), 2 K21
    launches; K21 on the refinement's input (every element outside the
    bracketing bin replaced by 2 * hi: bin 511 takes almost all); the
    count the threshold keeps against k, the bracketing bin's occupancy,
    the gap to the exact k-th value (``torch.kthvalue``); the whole
    threshold and ``torch.kthvalue`` timed.  Returns (K21 cases, threshold
    cases, K21's launches in the threshold runs through it: the counter
    read just before and just after each run)."""
    k21, thr, path = [], [], 0
    for label, x in topk_inputs(torch):
        n = x.numel()
        a = x.reshape(-1).float().abs()
        hi = a.max() + 1e-12
        k21.append(k21_case(torch, timer, tk, f"{label}, first pass", x, hi))
        for frac in TOPK_FRACTIONS:
            k = max(1, int(frac * n))
            runs = {"kernel": [], "plain": []}

            def recording(side, fn):
                def h(xx, lim):
                    out = fn(xx, lim)
                    runs[side].append((xx, lim, out))
                    return out
                return h

            before = tk.launches
            t_k = ops.topk_threshold(x, k, histogram=recording("kernel", tk.histogram_abs))
            launched = tk.launches - before
            path += launched
            t_p = ops.topk_threshold(x, k, histogram=recording("plain", tk.histogram_abs_plain))
            if launched != 2:
                raise AssertionError(f"topk_threshold {label}: {launched} K21 launches, not 2")
            for (_, _, hk), (_, _, hp) in zip(runs["kernel"], runs["plain"]):
                if not torch.equal(hk, hp):
                    raise AssertionError(f"topk_threshold {label} k={k}: K21's histogram "
                                         f"differs from the plain version's")
            if t_k.view(torch.int32).item() != t_p.view(torch.int32).item():
                raise AssertionError(f"topk_threshold {label} k={k}: {float(t_k)!r} through "
                                     f"K21, {float(t_p)!r} on the plain path")
            hist = runs["kernel"][0][2][0]
            desc = torch.cumsum(hist.flip(0), 0)
            bracket = tk.N_BINS - 1 - int(torch.argmax((desc >= k).to(torch.uint8)))
            exact = torch.kthvalue(a, n - k + 1).values
            kept = int((a >= t_k).sum())
            refine_in, lim = runs["kernel"][1][:2]
            del runs
            k21.append(k21_case(torch, timer, tk, f"{label}, refinement input k={k}",
                                refine_in, lim))
            del refine_in
            case = {"case": f"{label} k={k} ({frac:g} n)", "n": n, "k": k,
                    "threshold": float(t_k), "kth_value": float(exact),
                    "threshold_minus_kth": float(t_k - exact), "kept": kept,
                    "abs_kept_minus_k": abs(kept - k), "bracket_bin": bracket,
                    "bracket_occupancy": int(hist[bracket]),
                    "ms": timer(lambda: ops.topk_threshold(x, k)),
                    "kthvalue_ms": timer(lambda: torch.kthvalue(a, n - k + 1), reps=2,
                                         warmup=1)}
            print("topk_threshold", json.dumps(case))
            thr.append(case)
        del x, a
        torch.cuda.empty_cache()
    return k21, thr, {"histogram_abs": path}


# ---------------------------------------------------------------------------
# the paper's baselines: set, snfs, topkast (block-sparse), pruning, snip
# (masked), through train_loop
# ---------------------------------------------------------------------------

METHOD_STEPS = 4  # a drop/grow at step 2 (t_end = 3/4 of 4 steps)


def methods_config(method):
    """h2o-danube-1.8b at full width and depth, flash_tight, ERK 0.8, 2 x
    1024 tokens in one microbatch, a drop/grow every 2 steps: block_sparse
    128x128 for the drop/grow methods, masked for pruning and snip."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    kernel = "masked" if method in ("pruning", "snip") else "block_sparse"
    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel=kernel, block=128,
                           attn_kernel="flash_tight")
    return dataclasses.replace(cfg, microbatches=1, sparse=dataclasses.replace(
        cfg.sparse, method=method, delta_t=DELTA_T))


def method_train(torch, bsm, mm, fa, tk, method):
    """``train_loop`` (Adam, warmup-cosine, the CLI's defaults) for one
    method at full size, 4 steps of 2 x 1024 tokens, the launch counters set
    to 0 just before it and read after every step, each step's launches
    exact: per step 2 * 168 forward launches (remat), 168 dgrad, 168 wgrad
    (K1/K2/K3 under block_sparse, with their planned split merges,
    K13/K14/K15 under masked, with K14's and K15's), 48/24/24 K9-K11, no
    K21.  SET carries no
    superset, so its update step takes the dense gradient of the masked
    weights (the reference's path): K9-K11 only.  SNIP's one-shot gradient
    runs before step 0 and adds its attention launches (48/24/24 K9-K11) to
    step 0's count.  Checks at the
    topology change: block counts kept per layer, grown = dropped, some
    block moved (set, snfs), the pack fresh; B ⊇ A (snfs, topkast), the
    dense momentum zero outside B (snfs), the weights exactly 0 outside B
    (topkast); pruning's masks monotone and at the schedule's target
    density after its prune at step 0; SNIP's per-layer density the ERK
    map's.  Returns (stats, launches)."""
    from repro_torch.core.distributions import sparsity_map
    from repro_torch.core.masks import block_mask_of, tree_map, tree_paths
    from repro_torch.core.pack import pack_mismatch, validate_pack
    from repro_torch.core.pruning import PruningSchedule
    from repro_torch.launch.train import train_loop

    cfg = methods_config(method)
    masked = cfg.sparse.kernel == "masked"
    mod = mm if masked else bsm
    fwd, dx, dw = (("masked_fwd", "masked_dx", "masked_dw") if masked else
                   ("block_sparse_fwd", "block_sparse_dx", "block_sparse_dw"))
    counters = ((fwd, mod, "launches"), (dx, mod, "dx_launches"), (dw, mod, "dw_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"), ("histogram_abs", tk, "launches"))
    n_proj, n_attn = 7 * cfg.n_layers, cfg.n_layers
    expect = {fwd: 2 * n_proj, dx: n_proj, dw: n_proj, "flash_fwd": 2 * n_attn,
              "flash_dq": n_attn, "flash_dkv": n_attn, "histogram_abs": 0}
    if masked:  # K14's and K15's planned split merges, set from the weights' shapes at step 1
        counters += (("masked_dx_merge", mm, "dx_merge_launches"),
                     ("masked_dw_merge", mm, "dw_merge_launches"))
    else:  # K1's, K2's and K3's planned split merges, on the pack each step runs on
        counters += (("block_sparse_fwd_merge", bsm, "fwd_merge_launches"),
                     ("block_sparse_dx_merge", bsm, "dx_merge_launches"),
                     ("block_sparse_dw_merge", bsm, "dw_merge_launches"))
    read = lambda: {n: getattr(m, a) for n, m, a in counters}
    # set carries no superset: its update step takes the dense gradient on
    # the masked weights (the reference's legacy path), attention alone on
    # the kernels
    update = dict(expect, **({fwd: 0, dx: 0, dw: 0, "block_sparse_fwd_merge": 0,
                              "block_sparse_dx_merge": 0, "block_sparse_dw_merge": 0}
                             if method == "set" else {}))
    first = dict(expect)
    if method == "snip":
        first.update(flash_fwd=4 * n_attn, flash_dq=2 * n_attn, flash_dkv=2 * n_attn)
    blk = cfg.sparse.block_shape
    units = (lambda m: m) if masked else (lambda m: block_mask_of(m, blk))
    log, seen = [], {"counts": None, "t": None, "before": None, "checks": {}, "bs_merges": None}
    # train_loop's schedule; its one prune (step 0) goes to the target at step 1
    prune_target = PruningSchedule(cfg.sparse.sparsity, METHOD_STEPS // 8,
                                   int(METHOD_STEPS * 0.75), max(DELTA_T * 10, 1)).target(1)

    def check_update(state):
        masks = tree_paths(state["masks"])
        bwd = tree_paths(state.get("bwd_masks") or state["masks"])
        params = tree_paths(state["params"])
        mom = tree_paths(state["dense_mom"]) if method == "snfs" else None
        moved = 0
        for n, m in masks.items():
            a0, a1, b = seen["before"][n], units(m), units(bwd[n])
            dropped, grown = int((a0 & ~a1).sum()), int((a1 & ~a0).sum())
            moved += grown
            if int(a1.sum()) != int(a0.sum()) or (a1 & ~b).any():
                raise AssertionError(f"{method} {n}: {int(a0.sum())} -> {int(a1.sum())} "
                                     "units, or the superset misses the mask")
            if grown != dropped:
                raise AssertionError(f"{method} {n}: grew {grown}, dropped {dropped}")
            outside = lambda t: torch.where(bwd[n], 0.0, t).abs().max().item()
            if method == "snfs" and outside(mom[n]) != 0.0:
                raise AssertionError(f"snfs {n}: dense momentum outside the superset")
            if method == "topkast" and outside(params[n]) != 0.0:
                raise AssertionError(f"topkast {n}: weights outside the superset")
        validate_pack(state["pack"], where=f"chip_smoke {method}")
        stale = int(pack_mismatch(state["masks"], state["pack"], blk,
                                  bwd_masks=state.get("bwd_masks")))
        if stale:
            raise AssertionError(f"{method}: pack stale after the update: {stale} blocks")
        seen["checks"]["units_moved"] = moved
        if moved == 0 and method in ("set", "snfs"):
            raise AssertionError(f"{method}: the drop/grow moved no block")

    def on_step(step, is_update, state, m):
        torch.cuda.synchronize()
        t, counts = time.perf_counter(), read()
        prev = seen["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if seen["t"] is not None:
            rec["wall_s"] = t - seen["t"]
        if masked and "masked_dx_merge" not in expect:
            n_merges = {e: cfg.n_layers * planned_merges(
                torch, mm, cfg, state["params"]["layers"][0], MASKED_BATCH * TRAIN_SEQ, e)
                for e in ("dx", "dw")}
            for d in (expect, update, first):
                d["masked_dx_merge"], d["masked_dw_merge"] = n_merges["dx"], n_merges["dw"]
        want = first if step == 1 else update if is_update else expect
        if not masked:  # the pack the step ran on: the one it left, unless it updated
            now = {e: bs_merges(torch, cfg, state, MASKED_BATCH * TRAIN_SEQ, e)
                   for e in BS_ENTRIES}
            ran = seen["bs_merges"] if is_update else now
            # remat: K1 and its merges twice
            want = dict(want, block_sparse_fwd_merge=want.get(
                "block_sparse_fwd_merge", 2 * ran["bs_fwd"]),
                block_sparse_dx_merge=want.get("block_sparse_dx_merge", ran["bs_dx"]),
                block_sparse_dw_merge=want.get("block_sparse_dw_merge", ran["bs_dw"]))
            seen["bs_merges"] = now
        if rec["launches"] != want or not math.isfinite(rec["loss"]):
            raise AssertionError(f"{method} step {step}: {rec}, expected {want}")
        masks = tree_paths(state["masks"])
        if step == 1 and method == "pruning":  # after the prune at step 0
            for n, mk in masks.items():
                want_n = int(torch.round((1.0 - prune_target) * mk.numel()))
                if int(mk.sum()) != want_n:
                    raise AssertionError(f"pruning {n}: {int(mk.sum())} kept, the "
                                         f"schedule's target keeps {want_n}")
            seen["before"] = {n: mk.clone() for n, mk in masks.items()}
            seen["checks"]["density_after_prune"] = (
                sum(int(mk.sum()) for mk in masks.values())
                / sum(mk.numel() for mk in masks.values()))
        if step == 1 and method == "snip":
            flags = tree_map(lambda _, mk: mk is not None, state["masks"])
            smap = sparsity_map(cfg, state["params"], flags)
            for n, mk in masks.items():
                if int(mk.sum()) != round((1.0 - smap[n]) * mk.numel()):
                    raise AssertionError(f"snip {n}: {int(mk.sum())} kept at ERK "
                                         f"sparsity {smap[n]}")
            seen["checks"]["density_after_snip"] = (
                sum(int(mk.sum()) for mk in masks.values())
                / sum(mk.numel() for mk in masks.values()))
        if step == DELTA_T and not masked:
            seen["before"] = {n: units(mk).clone() for n, mk in masks.items()}
        if is_update:
            check_update(state)
        print(f"{method} train:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        seen.update(counts=read(), t=time.perf_counter())

    for _, m, a in counters:
        setattr(m, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = train_loop(cfg, steps=METHOD_STEPS, batch=MASKED_BATCH, seq=TRAIN_SEQ,
                          workdir=str(ROOT / "chiprun_out" / f"methods_{method}"),
                          device="cuda", on_step=on_step, log_every=METHOD_STEPS,
                          ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()
    if method == "pruning":
        for n, mk in tree_paths(state["masks"]).items():
            if (mk & ~seen["before"][n]).any():
                raise AssertionError(f"pruning {n}: a pruned connection returned")
    n_updates = sum(r["update"] for r in log)
    if n_updates != (0 if masked else 1):
        raise AssertionError(f"{method}: {n_updates} topology updates")
    result = json.loads((ROOT / "chiprun_out" / f"methods_{method}" / "result.json").read_text())
    del state
    torch.cuda.empty_cache()
    steady = [r for r in log if "wall_s" in r and not r["update"]]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    stats = {"method": method, "kernel": cfg.sparse.kernel, "steps": METHOD_STEPS,
             "tokens_per_step": MASKED_BATCH * TRAIN_SEQ, "total_s": total_s,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "mean_train_step_wall_s": wall, "steady_steps": [r["step"] for r in steady],
             "tok_per_s": MASKED_BATCH * TRAIN_SEQ / wall,
             "update_step_wall_s": [r["wall_s"] for r in log if r["update"]],
             "losses": [r["loss"] for r in log], "checks": seen["checks"],
             "topology": result["topology"], "sparsity": result["sparsity"]}
    print(f"{method} train ({cfg.sparse.kernel}): {METHOD_STEPS} steps of {MASKED_BATCH} x "
          f"{TRAIN_SEQ} tokens in {total_s:.1f} s; train step {wall:.3f} s wall = "
          f"{stats['tok_per_s']:.0f} tok/s; update step {stats['update_step_wall_s']}; "
          f"peak {stats['peak_mem_gib']:.1f} GiB; {seen['checks']}; launches {launches}")
    return stats, launches


# ---------------------------------------------------------------------------
# checkpoints and restarts, the fault injector with observability, lockstep
# ---------------------------------------------------------------------------

RESUME_LAYERS, RESUME_PREEMPT = 4, 3
BS_TRAIN_COUNTERS = (
    ("block_sparse_fwd", "bsm", "launches"), ("block_sparse_dx", "bsm", "dx_launches"),
    ("block_sparse_dw", "bsm", "dw_launches"),
    ("block_sparse_fwd_merge", "bsm", "fwd_merge_launches"),
    ("block_sparse_dx_merge", "bsm", "dx_merge_launches"),
    ("block_sparse_dw_merge", "bsm", "dw_merge_launches"),
    ("flash_fwd", "fa", "launches"), ("flash_dq", "fa", "dq_launches"),
    ("flash_dkv", "fa", "dkv_launches"))


def read_counters(mods, counters=BS_TRAIN_COUNTERS):
    return {n: getattr(mods[m], a) for n, m, a in counters}


def zero_counters(mods, counters=BS_TRAIN_COUNTERS):
    for _, m, a in counters:
        setattr(mods[m], a, 0)


def resume_config():
    """The train phase's danube (block_sparse 128x128, flash_tight, ERK 0.8,
    RigL with the Top-KAST superset, delta_t 2) at full width, 4 of 24
    layers, with updates until the end of the run (steps 2 and 4)."""
    cfg = train_config()
    return dataclasses.replace(cfg, n_layers=RESUME_LAYERS, sparse=dataclasses.replace(
        cfg.sparse, t_end_fraction=1.0))


def state_bytes(torch, state):
    """Bytes of every leaf of a train state as it lies (host ints 4)."""
    from repro_torch.core.masks import tree_map

    out = []
    tree_map(lambda _, v: out.append(
        0 if v is None else v.numel() * v.element_size() if torch.is_tensor(v) else 4),
        state)
    return sum(out)


def same_state(torch, a, b):
    """[names of the leaves that differ] between two train states, bit for
    bit (floats compared as their bits, so NaNs and signed zeros count)."""
    from repro_torch.core.masks import tree_map

    bad = []

    def cmp(name, x, y):
        if x is None or not torch.is_tensor(x):
            if x != y:
                bad.append(name)
            return
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(name)
            return
        if x.is_floating_point():
            x, y = (t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                    for t in (x, y))
        if not torch.equal(x, y):
            bad.append(name)

    tree_map(cmp, a, b)
    return bad


def resume_phase(torch, bsm, fa):
    """``run_with_restarts(preempt_at=3, ckpt_every=0)`` against an
    uninterrupted 6-step ``train_loop`` from the same seed, at full width
    (4 of 24 layers): every leaf of params, masks, supersets, Adam state,
    pack and the non-finite counter bit for bit equal; the losses after
    the restart equal; the pack valid and fresh after the restore; the
    checkpoint's bytes, the snapshot, write, wait and restore seconds, and
    the step times before and after the restart."""
    import shutil

    import numpy as np
    from repro_torch.core.masks import tree_map, tree_paths
    from repro_torch.core.pack import pack_mismatch, validate_pack
    from repro_torch.launch import train as tl
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    cfg = resume_config()
    mods = {"bsm": bsm, "fa": fa}
    work = ROOT / "build" / "resume"
    shutil.rmtree(work, ignore_errors=True)
    probe, _ = init_train_state(cfg, OptConfig(kind="adam", weight_decay=0.0,
                                                grad_clip=1.0), seed=0, device="cuda")
    reckoned = state_bytes(torch, probe)
    mask_elems = sum(m.numel() for m in tree_paths(probe["masks"]).values())
    del probe
    torch.cuda.empty_cache()
    free = shutil.disk_usage(ROOT).free
    print(f"resume: danube {cfg.n_layers} layers at full width; the train state "
          f"reckons {reckoned / 2**30:.2f} GiB ({mask_elems / 1e6:.1f} M mask "
          f"elements: {mask_elems / 2**30:.2f} GiB as bool, "
          f"{mask_elems / 8 / 2**30:.3f} GiB bit-packed); {free / 2**30:.0f} GiB "
          f"free on disk")

    saves, restores = [], []

    class Timed(tl.Checkpointer):
        """The loop's checkpointer, recording each save's timings."""

        def wait(self):
            pending = self._thread is not None
            super().wait()
            if pending:
                saves.append(dict(self.timings))

        def restore_or_none(self, like):
            t0 = time.perf_counter()
            got = super().restore_or_none(like)
            torch.cuda.synchronize()
            if got[0] is not None:
                restores.append(time.perf_counter() - t0)
            return got

    def recorder(log, check_pack=False):
        last = [None]

        def on_step(step, is_update, state, m):
            torch.cuda.synchronize()
            now = time.perf_counter()
            rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
                   "launches": read_counters(mods)}
            if last[0] is not None:
                rec["wall_s"] = now - last[0]
            if check_pack and step == RESUME_PREEMPT + 1:
                # the first step after the restore ran on the re-packed state
                validate_pack(state["pack"], where="chip_smoke resume")
                rec["pack_stale"] = int(pack_mismatch(
                    state["masks"], state["pack"], cfg.sparse.block_shape,
                    bwd_masks=state["bwd_masks"]))
            log.append(rec)
            torch.cuda.synchronize()
            last[0] = time.perf_counter()

        return on_step

    kw = dict(cfg=cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              log_every=TRAIN_STEPS, device="cuda")
    tl.Checkpointer, plain_ckpt = Timed, tl.Checkpointer
    try:
        zero_counters(mods)
        log_r = []
        t0 = time.perf_counter()
        resumed, _ = tl.run_with_restarts(
            workdir=str(work / "resumed"), preempt_at=RESUME_PREEMPT, ckpt_every=0,
            on_step=recorder(log_r, check_pack=True), **kw)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        launches = read_counters(mods)
        log_s = []
        straight, _ = tl.train_loop(workdir=str(work / "straight"), ckpt_every=None,
                                    on_step=recorder(log_s), **kw)
        torch.cuda.synchronize()
    finally:
        tl.Checkpointer = plain_ckpt
    ckpt_dir = work / "resumed" / "ckpt"
    disk = {}
    for d in sorted(ckpt_dir.glob("step-*")):
        blob = d / "arrays.npz"
        with np.load(blob) as z:
            packed = sum(z[k].nbytes for k in z.files if k.startswith("__packedmask__"))
        disk[d.name] = {"bytes": blob.stat().st_size, "mask_packed_bytes": packed}
    bad = same_state(torch, resumed, straight)
    shutil.rmtree(work, ignore_errors=True)

    steps_r = [r["step"] for r in log_r]
    if steps_r != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"resume: the restarted run stepped {steps_r}")
    if [r["update"] for r in log_s] != [s in (3, 5) for s in range(1, TRAIN_STEPS + 1)]:
        raise AssertionError(f"resume: updates at {[r['step'] for r in log_s if r['update']]}, "
                             "expected after steps 2 and 4")
    if bad:
        raise AssertionError(f"resume: {len(bad)} leaves differ from the uninterrupted "
                             f"run, first {bad[:8]}")
    losses_r = [r["loss"] for r in log_r][RESUME_PREEMPT:]
    losses_s = [r["loss"] for r in log_s][RESUME_PREEMPT:]
    if losses_r != losses_s or not all(math.isfinite(x) for x in losses_s):
        raise AssertionError(f"resume: losses after the restart {losses_r} vs {losses_s}")
    after = log_r[RESUME_PREEMPT]
    if after.get("pack_stale") != 0:
        raise AssertionError(f"resume: pack stale after the restore: {after}")
    if len(saves) != 2 or len(restores) != 1 or len(disk) != 2:
        raise AssertionError(f"resume: {len(saves)} saves, {len(restores)} restores, "
                             f"checkpoints {sorted(disk)}")
    for name in ("block_sparse_fwd", "block_sparse_dx", "block_sparse_dw", "flash_fwd",
                 "flash_dq", "flash_dkv"):
        if launches[name] == 0:
            raise AssertionError(f"resume: kernel {name} was not launched")
    wall = lambda log, lo, hi: [round(r["wall_s"], 4) for r in log
                                if "wall_s" in r and lo < r["step"] <= hi]
    stats = {
        "layers": cfg.n_layers, "state_bytes_reckoned": reckoned,
        "mask_elements": mask_elems, "checkpoints": disk, "saves": saves,
        "restore_s": restores[0], "resumed_run_s": resumed_s,
        "losses": losses_s, "losses_resumed": [r["loss"] for r in log_r],
        "step_wall_s_before_restart": wall(log_r, 0, RESUME_PREEMPT),
        "step_wall_s_after_restart": wall(log_r, RESUME_PREEMPT + 1, TRAIN_STEPS),
        "step_wall_s_uninterrupted": wall(log_s, 0, TRAIN_STEPS),
    }
    n_leaves = []
    tree_map(lambda *_: n_leaves.append(1), straight)
    stats["leaves_compared"] = len(n_leaves)
    for name, d in disk.items():
        print(f"resume: {name}: {d['bytes'] / 2**30:.3f} GiB on disk (reckoned "
              f"{reckoned / 2**30:.3f}); masks {d['mask_packed_bytes'] / 2**20:.1f} MiB "
              f"bit-packed against {mask_elems / 2**20:.1f} MiB as bool")
    for i, s in enumerate(saves):
        print(f"resume: save {i}: snapshot {s['snapshot_s']:.3f} s, background write "
              f"{s['write_s']:.3f} s, wait {s['wait_s']:.3f} s")
    print(f"resume: restore {restores[0]:.3f} s; {len(n_leaves)} leaves bit for bit equal "
          f"to the uninterrupted run's; losses after the restart {losses_r}; step wall "
          f"s before the restart {stats['step_wall_s_before_restart']}, after "
          f"{stats['step_wall_s_after_restart']}, uninterrupted "
          f"{stats['step_wall_s_uninterrupted']}; launches {launches}")
    return stats, launches


SERVE_COUNTERS = (("block_sparse_fwd", "bsm", "launches"),
                  ("block_sparse_fwd_merge", "bsm", "fwd_merge_launches"),
                  ("flash_fwd", "fa", "launches"))
CHAOS_PREFILL_RID = 6
CHAOS_DECODE = ((2, 1, float("nan")), (5, 3, float("inf")))  # (step, slot, value)


def chaos_serve(torch, bsm, fa, fault_free):
    """The serve phase's model and 8 requests with ``obs`` and a
    ``FaultInjector``: two decode rows of active slots poisoned (NaN, inf)
    and one request's every prefill; ``max_retries=1``.  The poisoned
    prefill FAILED after its retry, the other 7 DONE with the fault-free
    tokens (``fault_free``: {rid: tokens} of the serve phase); quarantine
    instants = ``quarantine_log``, each joined to a fired injector entry;
    the metrics text and the Chrome trace written and read back; then the
    same requests with ``obs=None`` and no faults.  Returns (stats,
    launches, (cfg, params, masks, pack))."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (
        configure_kernel,
        init_serving_state,
        staggered_requests,
    )
    from repro_torch.obs import MetricsRegistry, Observability, parse_prometheus_text
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.queue import Status

    mods = {"bsm": bsm, "fa": fa}
    cfg = configure_kernel(get_config("h2o-danube-1.8b"), kernel="block_sparse",
                           block=128, attn_kernel="flash_tight")
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    out_dir = ROOT / "chiprun_out"
    trace_path, metrics_path = out_dir / "chaos_trace.json", out_dir / "chaos_metrics.prom"

    def serve(obs, faults):
        engine = ServeEngine(cfg, params, capacity=4, max_len=2048, masks=masks,
                             pack=pack, obs=obs, faults=faults, max_retries=1)
        reqs = staggered_requests(cfg, 8, prompt_lens=(100, 300, 1000), gen_lens=(32,),
                                  seed=0)
        for r in reqs:
            engine.submit(r)
        stats = engine.run()
        return engine, reqs, stats

    warm = ServeEngine(cfg, params, capacity=4, max_len=2048, masks=masks, pack=pack)
    for r in staggered_requests(cfg, 2, prompt_lens=(100,), gen_lens=(2,), seed=1):
        warm.submit(r)
    warm.run()
    serve_params = warm.params
    del warm

    obs = Observability(metrics=MetricsRegistry(), process_name="serve")
    injector = FaultInjector(0).poison_prefill(CHAOS_PREFILL_RID)
    for step, slot, value in CHAOS_DECODE:
        injector.poison_logits(step, slot, value)
    zero_counters(mods, SERVE_COUNTERS)
    engine, reqs, stats = serve(obs, injector)
    launches = read_counters(mods, SERVE_COUNTERS)
    obs.flusher(metrics_path=metrics_path, trace_path=trace_path).close(stats["wall_s"])
    plain_engine, plain_reqs, plain_stats = serve(None, None)

    failed = [r for r in reqs if r.status is Status.FAILED]
    if [r.rid for r in failed] != [CHAOS_PREFILL_RID] or failed[0].n_retries != 1:
        raise AssertionError(f"chaos: failed {[(r.rid, r.n_retries) for r in failed]}")
    for r in reqs:
        if r.rid != CHAOS_PREFILL_RID and (r.status is not Status.DONE
                                           or r.generated != fault_free[r.rid]):
            raise AssertionError(f"chaos: request {r.rid} {r.status} with tokens "
                                 "other than the fault-free run's")
    for r in plain_reqs:
        if r.status is not Status.DONE or r.generated != fault_free[r.rid]:
            raise AssertionError(f"chaos: obs=None, no faults: request {r.rid} differs")
    log = engine.quarantine_log
    decode_hits = {(s, sl) for s, sl, _ in CHAOS_DECODE}
    if sorted((q.step, q.slot) for q in log if q.where == "decode") != sorted(decode_hits):
        raise AssertionError(f"chaos: decode quarantines {log}")
    quar = obs.trace.find("quarantine")
    traced = [(e["args"]["step"], e["args"]["rid"], e["args"]["slot"],
               e["args"]["attempt"], e["args"]["where"]) for e in quar]
    if traced != [tuple(q) for q in log]:
        raise AssertionError(f"chaos: trace {traced} vs quarantine log {log}")
    fired_decode = {(e[1], s) for e in injector.log if e[0] == "decode" for s in e[2]}
    fired_prefill = {(e[1], e[2]) for e in injector.log if e[0] == "prefill"}
    for q in log:
        key = (q.step, q.slot) if q.where == "decode" else (q.rid, q.attempt)
        if key not in (fired_decode if q.where == "decode" else fired_prefill):
            raise AssertionError(f"chaos: quarantine {q} joins no fired injection")
    if len(fired_prefill) != 2 or len(log) != 4:
        raise AssertionError(f"chaos: injector log {injector.log}, quarantines {log}")
    parsed = parse_prometheus_text(metrics_path.read_text())
    by = {s: parsed["serve_requests_total"][frozenset({("status", s)})]
          for s in ("DONE", "FAILED")}
    if by != {"DONE": 7, "FAILED": 1}:
        raise AssertionError(f"chaos: metrics {by}")
    events = json.loads(trace_path.read_text())["traceEvents"]
    if not events or any(e["ph"] not in "XiCM" for e in events):
        raise AssertionError("chaos: the trace is not Chrome JSON")
    for name in ("block_sparse_fwd", "flash_fwd"):
        if launches[name] == 0:
            raise AssertionError(f"chaos: kernel {name} was not launched")
    out = {"stats": stats, "stats_obs_off": plain_stats,
           "decode_step_s_obs_on": stats["decode_step_s"],
           "decode_step_s_obs_off": plain_stats["decode_step_s"],
           "quarantine_log": [tuple(q) for q in log], "injector_log": [
               [x if not isinstance(x, float) else repr(x) for x in e] for e in injector.log],
           "trace_events": len(events), "trace_dropped": obs.trace.n_dropped,
           "metrics_bytes": metrics_path.stat().st_size}
    print(f"chaos: {stats['requests']} DONE with the fault-free tokens, "
          f"{stats['failed']} FAILED (rid {CHAOS_PREFILL_RID}, after its retry); "
          f"quarantines {out['quarantine_log']} = the trace's instants, each joined "
          f"to the injector's log {out['injector_log']}; metrics {by}; "
          f"{len(events)} trace events; host decode step "
          f"{1e3 * stats['decode_step_s']:.2f} ms with obs and faults, "
          f"{1e3 * plain_stats['decode_step_s']:.2f} ms without; tok/s "
          f"{stats['tok_per_s']:.1f} / {plain_stats['tok_per_s']:.1f}; launches {launches}")
    return out, launches, (cfg, serve_params, masks, pack)


LOCK_BATCH, LOCK_PROMPT, LOCK_GEN = 4, 48, 32


def lockstep_phase(torch, bsm, fa, model, engine_tok_s):
    """``serve_session`` (the CLI's defaults: batch 4, prompt 48, gen 32)
    on the serve phase's model: finite tokens, exactly 7 K1 launches a
    layer and one K9 a layer in the prefill and 7 K1 and no K9 in each
    decode step, and the prefill's last logits within the serve phase's
    tolerance of the plain dense path."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import lm_prefill

    cfg, params, masks, pack = model
    mods = {"bsm": bsm, "fa": fa}
    calls = []

    def counted(fn, kind):
        def run(*a, **k):
            before = read_counters(mods, SERVE_COUNTERS)
            out = fn(*a, **k)
            now = read_counters(mods, SERVE_COUNTERS)
            calls.append((kind, {n: now[n] - before[n] for n in now}))
            return out
        return run

    # warm-up (allocator, cuBLAS handles) before the counted run
    serve_mod.serve_session(cfg, params, batch=LOCK_BATCH, prompt_len=LOCK_PROMPT,
                            gen=2, masks=masks, pack=pack)
    prefill, decode = serve_mod.lm_prefill, serve_mod.lm_decode
    serve_mod.lm_prefill = counted(prefill, "prefill")
    serve_mod.lm_decode = counted(decode, "decode")
    try:
        zero_counters(mods, SERVE_COUNTERS)
        toks, stats = serve_mod.serve_session(cfg, params, batch=LOCK_BATCH,
                                              prompt_len=LOCK_PROMPT, gen=LOCK_GEN,
                                              masks=masks, pack=pack)
        launches = read_counters(mods, SERVE_COUNTERS)
    finally:
        serve_mod.lm_prefill, serve_mod.lm_decode = prefill, decode
    L = cfg.n_layers
    want = {"prefill": (7 * L, L), "decode": (7 * L, 0)}
    if [k for k, _ in calls] != ["prefill"] + ["decode"] * (LOCK_GEN - 1):
        raise AssertionError(f"lockstep: calls {[k for k, _ in calls]}")
    for i, (kind, got) in enumerate(calls):
        if (got["block_sparse_fwd"], got["flash_fwd"]) != want[kind]:
            raise AssertionError(f"lockstep: call {i} ({kind}) launched {got}, "
                                 f"expected K1, K9 = {want[kind]}")
    if tuple(toks.shape) != (LOCK_BATCH, LOCK_GEN) or int(toks.min()) < 0 or int(
            toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"lockstep: tokens {tuple(toks.shape)} out of range")
    # the prefill's last logits against the plain dense path on the prompt
    from repro_torch.data.synthetic import batch_for

    prompt = batch_for(cfg, 0, LOCK_BATCH, LOCK_PROMPT + 1, learnable=True,
                       device="cuda")["tokens"][:, :LOCK_PROMPT]
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))
    logits = {}
    for name, c in (("kernel", cfg), ("dense", dense)):
        lg, _ = lm_prefill(params, c, {"tokens": prompt}, LOCK_PROMPT + LOCK_GEN,
                           masks=masks, pack=pack)
        logits[name] = lg.float()[..., :cfg.vocab_size]
    a, b = logits["kernel"], logits["dense"]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("lockstep: prefill logits not finite")
    err = (a - b).abs().max().item()
    tol = 2e-2 * b.abs().max().item()
    if err > tol:
        raise AssertionError(f"lockstep: prefill logits err {err} > {tol}")
    agree = float((toks[:, 0].cpu() == b[:, -1].argmax(-1).cpu()).float().mean())
    stats.update({"logits_max_err": err, "logits_tol": tol, "calls": len(calls),
                  "first_token_agreement_with_dense": agree,
                  "engine_tok_per_s": engine_tok_s})
    print(f"lockstep: batch {LOCK_BATCH}, prompt {LOCK_PROMPT}, gen {LOCK_GEN}: prefill "
          f"{stats['prefill_s']:.4f} s, decode {1e3 * stats['decode_s_per_tok']:.2f} "
          f"ms/token, {stats['tok_per_s']:.1f} tok/s (the engine's "
          f"{engine_tok_s:.1f}); prefill logits max err {err:.4g} (tol {tol:.4g}); "
          f"K1 {want['prefill'][0]} and K9 {L} in the prefill, K1 {want['decode'][0]} "
          f"a decode step, exactly; launches {launches}")
    return stats, launches


# ---------------------------------------------------------------------------
# The paper's char-LM GRU on the byte corpus, and the planted teacher
# ---------------------------------------------------------------------------

GRU_STEPS, GRU_BATCH, GRU_SEQ, GRU_DELTA_T = 30, 8, 96, 10  # updates at steps 10, 20


def gru_phase(torch):
    """The paper's §4.2 char LM at its exact widths (embed 128, GRU 512,
    readouts 256/128, vocab 256) on the card: the repo's byte corpus
    (``text_batch``, batch 8, seq 96, as ``benchmarks/char_lm.py``), uniform
    75% masks on the sparsifiable leaves, RigL with Adam (weight decay
    5e-4, grad clip 10, lr 7e-4), drop/grow every 10 steps, 30 steps.
    Checks: finite losses, the mean of the last 5 below the first 5's,
    every layer's nnz unchanged across the updates, and the grown
    connections' Adam state zero.  Then one planted-teacher batch on the
    card: shapes, finiteness, determinism in (seed, step), the targets'
    noise against the teacher's function.  No kernel: the model runs plain
    matmuls, as the reference."""
    from repro_torch.core.distributions import LayerSpec, get_distribution
    from repro_torch.core.masks import apply_masks, init_masks, tree_map, tree_paths
    from repro_torch.core.rigl import SparseAlgo, dense_to_sparse_grad, rigl_update
    from repro_torch.core.schedules import UpdateSchedule
    from repro_torch.data.teacher import make_teacher, teacher_batch, teacher_targets
    from repro_torch.data.text import byte_corpus, text_batch
    from repro_torch.models.gru import gru_lm_apply, gru_lm_init
    from repro_torch.optim.optimizers import (
        OptConfig,
        apply_opt,
        init_opt,
        reset_new_connections,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    params, flags = gru_lm_init(gen)
    flat_p, flat_f = tree_paths(params), tree_paths(flags)
    smap = get_distribution("uniform", [LayerSpec(n, tuple(flat_p[n].shape))
                                        for n, f in flat_f.items() if f], 0.75,
                            dense_first=False)
    masks = init_masks(gen, params, smap)
    params = apply_masks(params, masks)
    opt_cfg = OptConfig(kind="adam", weight_decay=5e-4, grad_clip=10.0)
    opt = init_opt(opt_cfg, params)
    algo = SparseAlgo(method="rigl", schedule=UpdateSchedule(
        delta_t=GRU_DELTA_T, t_end=GRU_STEPS, alpha=0.3))
    corpus = byte_corpus(str(ROOT))
    nnz = lambda m: {n: int(v.sum()) for n, v in tree_paths(m).items()}
    nnz0 = nnz(masks)

    def loss_and_grads(w, b):
        w = tree_map(lambda _, t: t.detach().requires_grad_(True), w)
        logits = gru_lm_apply(w, b["tokens"])
        lse = torch.logsumexp(logits, -1)
        loss = (lse - logits.gather(-1, b["targets"][..., None])[..., 0]).mean()
        leaves = tree_paths(w)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), tree_map(lambda n, _: dict(zip(leaves, grads))[n], w)

    log, times, updates = [], [], []
    for t in range(GRU_STEPS):
        nb = text_batch(t, GRU_BATCH, GRU_SEQ, corpus=corpus)
        b = {k: torch.from_numpy(v).long().cuda() for k, v in nb.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = loss_and_grads(apply_masks(params, masks), b)
        if algo.schedule.is_update_step(t):
            params, masks, grown = rigl_update(params, masks, g, t, algo, gen)
            opt = reset_new_connections(opt, grown)
            n_grown = sum(int(v.sum()) for v in tree_paths(grown).values())
            if nnz(masks) != nnz0:
                raise AssertionError(f"gru: step {t}: nnz {nnz(masks)} != {nnz0}")
            stale = [n for n, m in tree_paths(grown).items()
                     if float(tree_paths(opt["m"])[n][m].abs().max() if m.any() else 0) != 0]
            if stale:
                raise AssertionError(f"gru: step {t}: Adam state not reset on {stale}")
            updates.append({"step": t, "grown": n_grown})
        else:
            params, opt = apply_opt(opt_cfg, dense_to_sparse_grad(g, masks), opt, params,
                                    7e-4)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log.append(float(loss))
    if not all(math.isfinite(x) for x in log):
        raise AssertionError(f"gru: losses {log}")
    first, last = sum(log[:5]) / 5, sum(log[-5:]) / 5
    if not last < first:
        raise AssertionError(f"gru: loss did not fall: first 5 {first}, last 5 {last}")
    if not updates or any(u["grown"] == 0 for u in updates):
        raise AssertionError(f"gru: the drop/grow moved nothing: {updates}")
    steady = [s for t, s in enumerate(times) if t > 1 and not algo.schedule.is_update_step(t)]
    stats = {"steps": GRU_STEPS, "batch": GRU_BATCH, "seq": GRU_SEQ,
             "corpus_bytes": int(len(corpus)), "losses": log,
             "loss_first5": first, "loss_last5": last, "updates": updates,
             "nnz": nnz0, "step_ms": 1e3 * sum(steady) / len(steady),
             "update_step_ms": [1e3 * times[u["step"]] for u in updates]}

    # one planted-teacher batch on the card
    tgen = torch.Generator(device="cuda").manual_seed(0)
    teacher = make_teacher(tgen, sparsity=0.9)
    x, y = teacher_batch(teacher, 3)
    x2, y2 = teacher_batch(teacher, 3)
    noise = float((y - teacher_targets(teacher, x)).std())
    if (tuple(x.shape), tuple(y.shape)) != ((256, 32), (256, 16)) or \
            not bool(torch.isfinite(y).all()) or not (torch.equal(x, x2) and torch.equal(y, y2)) \
            or not 0.0 < noise < 0.02:
        raise AssertionError(f"gru: teacher batch {tuple(x.shape)} {tuple(y.shape)}, "
                             f"noise {noise}")
    stats["teacher"] = {"x": list(x.shape), "y": list(y.shape), "noise_std": noise,
                        "w1_density": float((teacher["w1"] != 0).float().mean()),
                        "w2_density": float((teacher["w2"] != 0).float().mean())}
    print(f"gru: char LM (embed 128, GRU 512, 256/128, vocab 256), uniform 75%, RigL + "
          f"Adam, {GRU_STEPS} steps of {GRU_BATCH} x {GRU_SEQ} bytes of a "
          f"{len(corpus)}-byte corpus: {stats['step_ms']:.2f} ms a step, loss "
          f"{first:.4f} (first 5) -> {last:.4f} (last 5), nnz {sum(nnz0.values())} kept "
          f"across updates {updates}; teacher", json.dumps(stats["teacher"]))
    return stats


# ---------------------------------------------------------------------------
# xLSTM (xlstm-1.3b): mLSTM + sLSTM, tied embeddings; K1/K4 (K13/K16) serve,
# K1-K6 (K13-K18) train, sLSTM's recurrent bank r through the grouped kernels
# once per time step
# ---------------------------------------------------------------------------

XLSTM_ENGINE = dict(capacity=4, max_len=2048)
XLSTM_TRAIN_LAYERS = 8  # one 7:1 period: 7 mLSTM and the sLSTM at layer 7
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH = 4, 2  # 2 x 1024 in one microbatch
XLSTM_PROJ = {"mlstm": 5, "slstm": 2}  # K1/K13 launches a layer a pass
R_ROWS = (1, 8, 16)  # the r bank's rows: a request's step, and C = 8, 16


def trace_busy(prof, path):
    """(busy ms, the 8 longest kernels as (name, ms, count), every kernel's
    name) of a profiled window, from its chrome trace: the profiler writes
    it on its C++ side, while ``key_averages`` builds a Python record of
    each of the ~10^5 events of an xLSTM step (tens of seconds).  Busy time
    counts kernels, copies and sets on the device; the trace file is
    deleted."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    by = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms, n = by.get(e["name"], (0.0, 0))
            by[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(((k, ms, n) for k, (ms, n) in by.items()), key=lambda t: -t[1])[:8]
    return sum(ms for ms, _ in by.values()), top, set(by)


def xlstm_config(kernel, n_layers=None):
    """xlstm-1.3b at its published widths (full depth unless ``n_layers``),
    ERK 0.8; block_sparse in 128x128 blocks or masked; RigL with the
    Top-KAST superset every ``DELTA_T`` steps in one microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("xlstm-1.3b"), kernel=kernel,
                           block=128 if kernel == "block_sparse" else None)
    return dataclasses.replace(
        cfg, n_layers=n_layers or cfg.n_layers, microbatches=1,
        sparse=dataclasses.replace(cfg.sparse, method="rigl", delta_t=DELTA_T))


def leaf_merges(torch, cfg, state, rows, bank_rows, entry):
    """Split merges of one pass over a stack's dispatched leaves (2-D
    projections at ``rows`` rows, 3-D banks -- xLSTM's r -- at
    ``bank_rows`` rows, each call) -> (2-D merges, bank merges): ``entry``
    "fwd" (K1/K4, K13/K16), "dx" (K2/K5, K14/K17) or "dw" (K3/K6 on the
    superset's live blocks, K15/K18), each on its plan from the shapes,
    the dtype the model calls it in (the attention's in the compute dtype,
    every other leaf in the residual's dtype: f32, or the compute dtype
    under a frames frontend) and (block-sparse) the pack entry's live
    blocks, as the wrappers pick it."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.core.pack import pack_entries
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels.ops import _row_tile
    from repro_torch.models.layers import compute_dtype

    params = tree_paths(state["params"])
    bm, bn, bk = cfg.sparse.kernel_block
    dev = torch.cuda.current_device()
    bs = cfg.sparse.kernel == "block_sparse"
    leaves = (dict(pack_entries(state["pack"])) if bs
              else {n: None for n in tree_paths(state["masks"])})
    n2 = nr = 0
    for name, e in leaves.items():
        w = params[name]
        G, (K, N) = (w.shape[0] if w.dim() == 3 else 1), w.shape[-2:]
        _, Mp = _row_tile(bank_rows if w.dim() == 3 else rows, bm)
        dt = (compute_dtype(cfg) if "/attn/" in f"/{name}" or cfg.frontend == "frames"
              else torch.float32)
        if bs and entry == "dw":
            plan = bsm._dw_plan_for(Mp, K, N, G, dt, bn, e["bnnz"] if "bidx" in e
                                    else e["nnz"], dev)
        elif bs and entry == "dx":
            plan = bsm._dx_plan_for(Mp, K, N, G, dt, bk, bn, e["nnz"], dev)
        elif bs:
            plan = bsm._fwd_plan_for(Mp, K, N, G, dt, bk, bn, e["nnz"], dev)
        elif entry == "dw":
            plan = mm._fwd_plan_for(K, Mp, N, G, dt, bn, dev, "dw")
        elif entry == "dx":
            plan = mm._fwd_plan_for(Mp, N, K, G, dt, bk, dev, "dx")
        else:
            plan = mm._fwd_plan_for(Mp, K, N, G, dt, bn, dev)
        if w.dim() == 3:
            nr += plan[2] > 1
        else:
            n2 += plan[2] > 1
    return n2, nr


def xlstm_serve(torch, bsm, mm, kernel):
    """Serve xlstm-1.3b at full width and depth (48 layers: 42 mLSTM, 6
    sLSTM; tied embeddings; ERK 0.8, seed 0) under ``kernel``: the serve
    phase's 8 staggered greedy requests (prompts 100/300/1000, 32 tokens,
    capacity 4) under block_sparse (128x128 blocks: K1, and K4 for r), 4
    (prompts 100/300, 16 tokens) under masked (K13, K16).  Exact-length
    prefills.  Checks: every request DONE, nothing quarantined; exactly
    222 K1 (K13) a prefill and a decode step (42 x 5 + 6 x 2), 6 K4 (K16)
    a decode step and 6 a prompt token, and the split merges the plans
    make; an inactive slot's states bit for bit unchanged by a decode
    step; the greedy streams of the first 4 requests (every prompt length)
    against the plain dense path's on the same weights (the share of
    tokens that agree, at least 90%) and the 100- and 300-token prompts'
    prefill logits within 2e-3 of the largest.  Prefill ms per request,
    the decode step's host ms and its device ms (CUDA graph)."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.launch.serve import init_serving_state, staggered_requests
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    bs = kernel == "block_sparse"
    label = f"xlstm serve {kernel}"
    cfg = xlstm_config(kernel)
    fam, mod = ("block_sparse", bsm) if bs else ("masked", mm)
    k1, k4, merge = f"{fam}_fwd", f"grouped_{fam}_fwd", f"{fam}_fwd_merge"
    counters = ((k1, "launches"), (k4, "g_launches"), (merge, "fwd_merge_launches"))
    read = lambda: {n: getattr(mod, a) for n, a in counters}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_paths(params).values())
    engine = ServeEngine(cfg, params, masks=masks, pack=pack, **XLSTM_ENGINE)
    torch.cuda.synchronize()
    print(f"{label}: xlstm-1.3b ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {n_params / 1e9:.3f} B parameters, "
          f"{4 * n_params / 1e9:.2f} GB f32) initialised in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    for r in staggered_requests(cfg, 2, prompt_lens=(20,), gen_lens=(2,), seed=1):
        engine.submit(r)
    engine.run()

    n_req, lens, gen = (8, (100, 300, 1000), 32) if bs else (4, (100, 300), 16)
    reqs = staggered_requests(cfg, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
    engine = ServeEngine(cfg, engine.params, masks=masks, pack=pack, **XLSTM_ENGINE)
    for r in reqs:
        engine.submit(r)
    for _, a in counters:
        setattr(mod, a, 0)
    stats = engine.run()
    launches = read()
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != gen:
            raise AssertionError(f"{label}: request {r.rid}: {r.status} with "
                                 f"{len(r.generated)} tokens")
    if stats["quarantined"] or stats["failed"]:
        raise AssertionError(f"{label}: quarantined/failed slots: {stats}")
    n_s = sum(cfg.is_slstm(i) for i in range(cfg.n_layers))
    per_call = sum(XLSTM_PROJ["slstm" if cfg.is_slstm(i) else "mlstm"]
                   for i in range(cfg.n_layers))
    calls = stats["decode_steps"] + stats["prefills"]
    prompt_tokens = sum(r.prompt_len for r in reqs)
    st = {"params": engine.params, "pack": pack, "masks": masks}
    dec = leaf_merges(torch, cfg, st, XLSTM_ENGINE["capacity"], XLSTM_ENGINE["capacity"],
                       "fwd")
    pre = {r.prompt_len: leaf_merges(torch, cfg, st, r.prompt_len, 1, "fwd") for r in reqs}
    expect = {k1: per_call * calls, k4: n_s * (stats["decode_steps"] + prompt_tokens),
              merge: stats["decode_steps"] * sum(dec)
              + sum(pre[r.prompt_len][0] + r.prompt_len * pre[r.prompt_len][1]
                    for r in reqs)}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")

    # one decode step at capacity, slot 0 inactive: exact launches, and the
    # inactive slot's states bit for bit
    tok = torch.from_numpy(engine.cur_tok[:, None]).cuda()
    pos = torch.from_numpy(engine.pos).cuda()
    active = torch.tensor([False, True, True, True], device="cuda")
    before = [{k: v[0].clone() for k, v in next(iter(c.values())).items()}
              for c in engine.caches]
    c0 = read()
    lm_decode(engine.params, cfg, engine.caches, tok, pos, masks=masks, pack=pack,
              active=active)
    step = {n: v - c0[n] for n, v in read().items()}
    want_step = {k1: per_call, k4: n_s, merge: sum(dec)}
    if step != want_step:
        raise AssertionError(f"{label}: one decode step launched {step}, expected {want_step}")
    frozen = all(torch.equal(next(iter(c.values()))[k][0], v)
                 for c, b in zip(engine.caches, before) for k, v in b.items())
    if not frozen:
        raise AssertionError(f"{label}: an inactive slot's state changed in a decode step")
    del before
    stats.update({"prefill_ms": 1e3 * stats["prefill_s"] / stats["prefills"],
                  "decode_step_ms": 1e3 * stats["decode_step_s"],
                  "launches_per_decode_step": step, "merges_per_prefill": {
                      str(p): list(m) for p, m in pre.items()},
                  "parameters": n_params, "inactive_slot_frozen": frozen,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

    # the plain dense path on the same weights: the same requests' greedy
    # streams, and each prompt's prefill logits
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, kernel="dense"))
    # (a request's stream does not depend on the others': the first 4,
    # every prompt length among them)
    dreqs = staggered_requests(cfg, 4, prompt_lens=lens, gen_lens=(gen,), seed=0)
    dengine = ServeEngine(dense, engine.params, **XLSTM_ENGINE)
    for r in dreqs:
        dengine.submit(r)
    dengine.run()
    same = sum(a == b for r, d in zip(reqs, dreqs) for a, b in zip(r.generated, d.generated))
    agree = same / sum(len(d.generated) for d in dreqs)
    errs, gaps = [], []
    V = cfg.vocab_size
    for r in reqs[:2]:  # the 100- and 300-token prompts
        toks = torch.from_numpy(r.tokens).long().cuda()[None]
        a = lm_prefill(engine.params, cfg, {"tokens": toks}, 0, masks=masks,
                       pack=pack)[0].float()[..., :V]
        b = lm_prefill(engine.params, dense, {"tokens": toks}, 0)[0].float()[..., :V]
        if not bool(torch.isfinite(a).all()) or a.shape != (1, 1, V):
            raise AssertionError(f"{label}: prefill logits not finite or of the wrong shape")
        errs.append((a - b).abs().max().item() / b.abs().max().item())
        top = b.flatten().topk(2).values
        gaps.append((top[0] - top[1]).item())
    stats["vs_dense"] = {"token_agreement": agree, "streams_equal": sum(
        r.generated == d.generated for r, d in zip(reqs, dreqs)), "requests": len(dreqs),
        "prefill_logits_rel_err_max": max(errs), "logits_tol": 2e-3,
        "dense_top2_gap_min": min(gaps)}
    print(f"{label}: vs the plain dense path:", json.dumps(stats["vs_dense"]))
    if max(errs) > 2e-3 or agree < 0.9:
        raise AssertionError(f"{label}: kernel path vs dense path: {stats['vs_dense']}")
    del dengine
    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode, label)
    print(f"{label}: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "wall_s", "tok_per_s",
        "prefill_ms", "decode_step_ms", "decode_step_device_ms", "peak_gib")}),
          f"launches {launches}; a decode step {step}")
    return stats, launches


def r_bank_cases(torch, timer, bsm, mm, state, cfg):
    """The grouped kernels at sLSTM's recurrent bank's shapes (G 4 heads,
    K 512, N 2048; layer 7's ERK topology and Top-KAST superset from the
    training state), f32, at C = 1, 8 and 16 rows (a request's step, a
    decode step and the training batch's padded rows): block-sparse K4,
    K5, K6 or masked K16, K17, K18, each against its plain version and
    timed on the wrapper's plan.  Bytes: the inputs, the active (K4/K5) or
    superset (K6) blocks, or the bank and its 1-byte mask (K16-K18), and
    the output once; operations 2 C per active (superset) weight.
    Library: torch.bmm on the zero-filled (pre-masked) bank."""
    bs = cfg.sparse.kernel == "block_sparse"
    blk = cfg.sparse.kernel_block[2]
    name = [i for i in range(cfg.n_layers) if cfg.is_slstm(i)][0]
    w = state["params"]["layers"][name]["slstm"]["r"]
    m = state["masks"]["layers"][name]["slstm"]["r"]
    b = state["bwd_masks"]["layers"][name]["slstm"]["r"]
    G, K, N = w.shape
    wm, nnz, bnnz, es = w * m, int(m.sum()), int(b.sum()), 4
    out = {"fwd": [], "dx": [], "dw": []}
    for C in R_ROWS:
        bm, Mp, x_c, x = grouped_rows(torch, G, C, K, torch.float32)
        _, _, g_c, g = grouped_rows(torch, G, C, N, torch.float32)
        tag = f"r bank layer{name} G={G} C={C}->{Mp} K={K} N={N}"

        def chk(kern, got, want, absp, n):
            return _check_within(torch, f"{kern} {tag}", got, want, absp, n, torch.float32)

        if bs:
            e = state["pack"]["layers"][name]["slstm"]["r"]
            idx, cnt, ridx, rcnt = e["idx"], e["cnt"], e["ridx"], e["rcnt"]
            bidx, bcnt = e["bidx"], e["bcnt"]
            live, blive = e["nnz"], e["bnnz"]
            nb = blk * blk
            fwd = lambda: bsm.grouped_block_sparse_matmul(x, w, idx, cnt, bm=bm, bn=blk,
                                                          bk=blk, live=live)
            fwd_p = lambda: bsm.grouped_block_sparse_matmul_plain(x, w, idx, cnt, blk, blk)
            dx = lambda: bsm.grouped_block_sparse_dx(g, w, ridx, rcnt, bm=bm, bn=blk, bk=blk,
                                                     live=live)
            dx_p = lambda: bsm.grouped_block_sparse_dx_plain(g, w, ridx, rcnt, blk, blk)
            dw = lambda: bsm.grouped_block_sparse_dw(x, g, bidx, bcnt, bn=blk, bk=blk,
                                                     live=blive)
            dw_p = lambda: bsm.grouped_block_sparse_dw_plain(x, g, bidx, bcnt, blk, blk)
            absps = (bsm.grouped_block_sparse_matmul_plain(x.abs(), w.abs(), idx, cnt, blk, blk),
                     bsm.grouped_block_sparse_dx_plain(g.abs(), w.abs(), ridx, rcnt, blk, blk),
                     bsm.grouped_block_sparse_dw_plain(x.abs(), g.abs(), bidx, bcnt, blk, blk))
            names = ("K4", "K5", "K6")
            w_bytes = (es * live * nb + 4 * (idx.numel() + cnt.numel()),
                       es * live * nb + 4 * (ridx.numel() + rcnt.numel()),
                       es * G * K * N + 4 * (bidx.numel() + bcnt.numel()))
            flops = (2.0 * C * live * nb, 2.0 * C * live * nb, 2.0 * C * blive * nb)
        else:
            fwd = lambda: mm.grouped_masked_matmul(x, w, m, bm=bm, bn=blk)
            fwd_p = lambda: mm.grouped_masked_matmul_plain(x, w, m)
            dx = lambda: mm.grouped_masked_dx(g, w, m, bm=bm, bk=blk)
            dx_p = lambda: mm.grouped_masked_dx_plain(g, w, m)
            dw = lambda: mm.grouped_masked_dw(x, g, b, bn=blk, bk=blk)
            dw_p = lambda: mm.grouped_masked_dw_plain(x, g, b)
            absps = (mm.grouped_masked_matmul_plain(x.abs(), w.abs(), m),
                     mm.grouped_masked_dx_plain(g.abs(), w.abs(), m),
                     mm.grouped_masked_dw_plain(x.abs(), g.abs(), b))
            names = ("K16", "K17", "K18")
            w_bytes = ((es + 1) * G * K * N, (es + 1) * G * K * N, (es + 1) * G * K * N)
            flops = (2.0 * C * nnz, 2.0 * C * nnz, 2.0 * C * bnnz)
        want = (fwd_p(), dx_p(), dw_p())
        checks = (lambda: chk(names[0], fwd()[:, :C], want[0][:, :C], absps[0][:, :C], K),
                  lambda: chk(names[1], dx()[:, :C], want[1][:, :C], absps[1][:, :C], N),
                  lambda: chk(names[2], dw(), want[2], absps[2], Mp))
        libs = (lambda: torch.bmm(x_c, wm), lambda: torch.bmm(g_c, wm.transpose(1, 2)),
                lambda: torch.bmm(x_c.transpose(1, 2), g_c) * b)
        io = (es * G * C * (K + N), es * G * C * (N + K), es * G * C * (K + N))
        for key, kern, run, plain, check, lib, wb, fl, o in zip(
                ("fwd", "dx", "dw"), names, (fwd, dx, dw), (fwd_p, dx_p, dw_p), checks, libs,
                w_bytes, flops, io):
            case = kernel_case(torch, timer, kern, f"{tag} density={nnz / m.numel():.4f}"
                               f" superset={bnnz / b.numel():.4f}", run, plain, lib, check,
                               o + wb, fl, torch.float32)
            if kern in ("K6", "K18"):
                got = run()
                if float(got[~b].abs().max()) != 0.0:
                    raise AssertionError(f"{kern} {tag}: dw outside the superset")
            out[key].append(case)
        del want, absps
    return out


def xlstm_train(torch, timer, bsm, mm, kernel):
    """Train xlstm-1.3b at full width, 8 of 48 layers (one 7:1 period: 7
    mLSTM, the sLSTM at layer 7; 275 M parameters with the tied table),
    ERK 0.8, RigL with the Top-KAST superset (Δ = 10%), Adam,
    warmup-cosine, seed 0, under ``kernel`` (block_sparse in 128x128
    blocks, or masked), 2 x 1024 tokens in one microbatch, 6 steps, a
    drop/grow at step 2.  First the grouped kernels at the r bank's shapes
    (``r_bank_cases``) and the step-0 loss and the gradients of
    layers/0/mlstm/wq, layers/7/slstm/w_in, layers/7/slstm/r and the tied
    table against the plain dense path; then ``train_loop`` with every
    counter set to 0 just before it: finite losses and the exact launches
    of every step (remat reruns each block's forward: 2 x 37 K1 and 2 x
    1024 K4; 37 K2 and K3; 1023 K5 (no dgrad into the sLSTM's zero
    initial state) and 1024 K6; the planned split merges of each), and
    after the update the counts kept, B ⊇ A and the pack (carrier) fresh.
    Reports step s, tok/s, peak GiB, the profiled step's busy share."""
    from repro_torch.core.masks import block_mask_of, tree_paths
    from repro_torch.core.pack import pack_entries, pack_mismatch, validate_pack
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    bs = kernel == "block_sparse"
    label = f"xlstm train {kernel}"
    cfg = xlstm_config(kernel, XLSTM_TRAIN_LAYERS)
    steps, batch, S = XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, TRAIN_SEQ
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_paths(state["params"]).values())
    part("init_s")
    cases = r_bank_cases(torch, timer, bsm, mm, state, cfg)
    part("r_bank_cases_s")
    dense_check = train_dense_check(
        torch, cfg, state, label=label,
        names=("layers/0/mlstm/wq/w", "layers/7/slstm/w_in/w", "layers/7/slstm/r",
               "embed/table"))
    part("dense_check_s")
    fam, gfam = ("block_sparse", "grouped_block_sparse") if bs else ("masked",
                                                                      "grouped_masked")
    mod = bsm if bs else mm

    # remat reruns each block's forward in the backward
    fw = 2 if cfg.remat else 1

    def merges_of(st):
        """(fwd, dx, dw) split merges of one step on ``st``'s pack."""
        out = []
        for entry, n_r in (("fwd", fw * S), ("dx", S - 1), ("dw", S)):
            n2, nr = leaf_merges(torch, cfg, st, batch * S, batch, entry)
            out.append((fw if entry == "fwd" else 1) * n2 + n_r * nr)
        return tuple(out)

    seen = {"merges": merges_of(state)}
    del state
    torch.cuda.empty_cache()
    counters = ((f"{fam}_fwd", mod, "launches"), (f"{fam}_dx", mod, "dx_launches"),
                (f"{fam}_dw", mod, "dw_launches"), (f"{gfam}_fwd", mod, "g_launches"),
                (f"{gfam}_dx", mod, "gdx_launches"), (f"{gfam}_dw", mod, "gdw_launches"),
                (f"{fam}_fwd_merge", mod, "fwd_merge_launches"),
                (f"{fam}_dx_merge", mod, "dx_merge_launches"),
                (f"{fam}_dw_merge", mod, "dw_merge_launches"))
    read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
    n_s = sum(cfg.is_slstm(i) for i in range(cfg.n_layers))
    proj = sum(XLSTM_PROJ["slstm" if cfg.is_slstm(i) else "mlstm"]
               for i in range(cfg.n_layers))

    def expected(m):
        return {f"{fam}_fwd": fw * proj, f"{fam}_dx": proj, f"{fam}_dw": proj,
                f"{gfam}_fwd": fw * S * n_s, f"{gfam}_dx": (S - 1) * n_s,
                f"{gfam}_dw": S * n_s, f"{fam}_fwd_merge": m[0], f"{fam}_dx_merge": m[1],
                f"{fam}_dw_merge": m[2]}

    log = []
    mark = {"counts": None, "t": None, "units": None, "prof": None}

    def units(masks):
        return {n: (block_mask_of(m, cfg.sparse.block_shape) if bs else m)
                for n, m in tree_paths(masks).items()}

    def on_step(step, is_update, st, met):
        torch.cuda.synchronize()
        t = time.perf_counter()
        counts = read()
        prev = mark["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(met["loss"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if mark["t"] is not None:
            rec["wall_s"] = t - mark["t"]
        # the step ran on the pack it left unless it updated the topology
        want = expected(mark["merges"] if is_update else merges_of(st))
        if rec["launches"] != want:
            raise AssertionError(f"{label} step {step}: launches {rec['launches']}, "
                                 f"expected {want}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{label} step {step}: loss {rec['loss']}")
        mark["merges"] = merges_of(st)
        if step == 1:
            mark["units"] = {n: u.cpu() for n, u in units(st["masks"]).items()}
        if step == steps - 1:
            # the device's kernels only: the step runs ~10^5 host ops, whose
            # records would cost more to gather than the step takes
            mark["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            mark["prof"].__enter__()
        elif step == steps:
            mark["prof"].__exit__(None, None, None)
        print(f"{label}:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark.update(counts=counts, t=time.perf_counter())

    mark["merges"] = seen["merges"]
    for _, m_, a in counters:
        setattr(m_, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = train_loop(cfg, steps=steps, batch=batch, seq=S,
                          workdir=str(ROOT / "chiprun_out" / f"xlstm_train_{kernel}"),
                          device="cuda", on_step=on_step, log_every=steps, ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    part("train_loop_s")
    launches = read()
    after, bwd = units(state["masks"]), units(state["bwd_masks"])
    moved = 0
    for n, u in after.items():
        before = mark["units"][n]
        if int(u.sum()) != int(before.sum()):
            raise AssertionError(f"{label}: {n}: {int(before.sum())} active units before "
                                 f"the update, {int(u.sum())} after")
        if (u & ~bwd[n]).any():
            raise AssertionError(f"{label}: {n}: the superset does not contain the mask")
        moved += int((u.cpu() & ~before).sum())
    if moved == 0:
        raise AssertionError(f"{label}: the drop/grow moved nothing")
    if bs:
        validate_pack(state["pack"], where="chip_smoke xlstm")
        stale = int(pack_mismatch(state["masks"], state["pack"], cfg.sparse.block_shape,
                                  bwd_masks=state["bwd_masks"]))
        if stale:
            raise AssertionError(f"{label}: pack stale after the update: {stale} blocks")
    else:
        carried = dict(pack_entries(state["pack"]))
        bw = tree_paths(state["bwd_masks"])
        if sorted(carried) != sorted(bw) or any(carried[n]["bwd_mask"] is not bw[n]
                                                for n in bw):
            raise AssertionError(f"{label}: the carrier does not hold the refreshed superset")
    del state
    torch.cuda.empty_cache()
    busy_ms, top, _ = trace_busy(mark["prof"],
                                 ROOT / "build" / f"xlstm_train_{kernel}_trace.json")
    part("checks_and_profile_s")
    steady = [r for r in log if "wall_s" in r and not r["update"] and r["step"] != steps]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    profiled = log[-1]
    upd = [r for r in log if r["update"]]
    stats = {
        "layers": cfg.n_layers, "parameters": n_params, "steps": steps,
        "tokens_per_step": batch * S, "total_s": total_s, "mean_train_step_wall_s": wall,
        "steady_steps": [r["step"] for r in steady], "tok_per_s": batch * S / wall,
        "update_step_wall_s": [r.get("wall_s") for r in upd],
        "steady_step_peak_gib": max(r["peak_gib"] for r in steady),
        "update_step_peak_gib": max(r["peak_gib"] for r in upd),
        "profiled_step_wall_s": profiled["wall_s"],
        "profiled_step_device_busy_ms": busy_ms or None,
        "profiled_step_busy_share": busy_ms / 1e3 / profiled["wall_s"] if busy_ms else None,
        "profiled_step_top": top,
        "losses": [r["loss"] for r in log], "launches_per_step": [r["launches"] for r in log],
        "units_moved": moved, "step0_vs_dense": dense_check, "phase_parts_s": parts,
    }
    share = stats["profiled_step_busy_share"]
    print(f"{label}: xlstm-1.3b {cfg.n_layers} of 48 layers ({n_params / 1e6:.1f} M "
          f"parameters), {steps} steps of {batch} x {S} tokens in {total_s:.1f} s; train step "
          f"{wall:.3f} s wall (mean of {len(steady)}) = {stats['tok_per_s']:.0f} tok/s; peak "
          f"{stats['steady_step_peak_gib']:.1f} GiB steady, "
          f"{stats['update_step_peak_gib']:.1f} GiB in the update step; profiled step busy "
          f"{busy_ms:.1f} ms of {profiled['wall_s']:.3f} s "
          f"({'not measured' if share is None else f'{share:.1%}'}); {moved} "
          f"{'blocks' if bs else 'weights'} moved by the drop/grow; launches {launches}; "
          f"parts {json.dumps({k: round(v, 1) for k, v in parts.items()})}")
    return stats, launches, cases


HYMBA_ENGINE = dict(capacity=4, max_len=2048, paged=True, page_size=16)
HYMBA_BLOCK = 64  # the largest power-of-two block dividing 1600, 320, 3200, 5504, 6400
HYMBA_PROJ = 9  # K1/K13 a layer a pass: wq, wk, wv, wo, in_proj, out_proj, wi, wg, wo
# (requests, prompt lengths, new tokens) a mode serves; 1500 wraps the 1024 ring
HYMBA_REQUESTS = {"block_sparse": (8, (200, 700, 1500), 32), "masked": (4, (200, 1500), 16)}
HYMBA_LOGITS_TOL = 5e-3  # of the largest logit: bf16 attention on both paths
# layer 0's projections whose kernels run under every candidate plan at 64 x 64
HYMBA_CASES = ("attn.wq", "attn.wk", "ssm.in_proj", "ssm.out_proj")
HYMBA_TRAIN_LAYERS = 4  # layer 0 global, 1-3 local (window 1024)
HYMBA_TRAIN_STEPS, HYMBA_TRAIN_BATCH, HYMBA_TRAIN_SEQ = 4, 1, 2048  # an update at step 2
# the step-0 gradients held against the plain dense path
HYMBA_GRAD_LEAVES = ("layers/0/ssm/in_proj/w", "layers/1/ssm/out_proj/w", "layers/0/attn/wq/w",
                     "layers/1/ssm/w_dt/w", "layers/0/ssm/a_log", "embed/table")
HYMBA_FLASH = ("flash_fwd_kernel<64, true>", "flash_dq_kernel<64, true>",
               "flash_dkv_kernel<64, true>")
HYMBA_TRAIN = dict(label="hymba train", config=lambda k, n: hymba_config(k, n),
                   layers=HYMBA_TRAIN_LAYERS, of=32, proj=HYMBA_PROJ, steps=HYMBA_TRAIN_STEPS,
                   batch=HYMBA_TRAIN_BATCH, seq=HYMBA_TRAIN_SEQ, grads=HYMBA_GRAD_LEAVES,
                   flash=HYMBA_FLASH, cases=HYMBA_CASES, update=True, opt=None)


def hymba_config(kernel, n_layers=None):
    """hymba-1.5b at its published widths (full depth unless ``n_layers``),
    ERK 0.8, flash_tight; block_sparse in 64x64 blocks, or masked on 64-wide
    column and contraction tiles (128 would pad d_model 1600 and the KV
    width 320); RigL with the Top-KAST superset every ``DELTA_T`` steps in
    one microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("hymba-1.5b"), kernel=kernel, block=HYMBA_BLOCK,
                           attn_kernel="flash_tight")
    sp = dataclasses.replace(cfg.sparse, method="rigl", delta_t=DELTA_T,
                             kernel_block=(128, HYMBA_BLOCK, HYMBA_BLOCK))
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, microbatches=1,
                               sparse=sp)


def flash_kernels_of(names):
    """The flash kernels' instantiations among a trace's kernel names."""
    return sorted({n[n.index("flash_"):n.index(">") + 1] for n in names
                   if "flash_" in n and "_kernel<" in n})


def hymba_serve(torch, timer, bsm, mm, fa, kernel):
    """Serve hymba-1.5b at full width and depth (32 layers: attention and
    the selective SSM side by side in every block, global attention at
    layers 0, 15 and 31 and a 1024 window elsewhere; tied embeddings; ERK
    0.8, seed 0) through the paged engine (a local ring pool and a global
    pool of 16-token pages beside the slot-batched SSM states; capacity 4,
    max_len 2048) under ``kernel``: 8 staggered greedy requests (prompts
    200/700/1500, 32 tokens) under block_sparse (64x64 blocks: K1), 4
    (prompts 200/1500, 16 tokens) under masked (K13); the 1500-token
    prompts wrap the local rings.  Exact-length prefills.  Checks: every
    request DONE, nothing quarantined, the pools' books clean; exactly 288
    K1 (K13) a prefill and a decode step (32 x 9 projections) and the split
    merges the plans make, 32 K9 a prompt; one profiled prefill runs the
    exact d = 64 K9 instantiation and no other flash kernel; an inactive
    slot's SSM state bit for bit unchanged by a decode step; the greedy
    streams of the first 4 requests against the plain dense path's on the
    same weights (the share of tokens that agree, at least 90%) and two
    prompts' prefill logits within 5e-3 of the largest (bf16 attention on
    both paths).  Prefill ms per request, the decode step's host ms and its
    device ms (CUDA graph).  Then K1 on layer 0's served packs (4 and 1500
    rows) or K13, K14 and K15 on its weights and masks (64-wide tiles),
    each under every candidate plan, at ``HYMBA_CASES``' projections:
    returns (stats, launches, those cases)."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.launch.serve import init_serving_state, staggered_requests
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    bs = kernel == "block_sparse"
    label = f"hymba serve {kernel}"
    cfg = hymba_config(kernel)
    fam, mod = ("block_sparse", bsm) if bs else ("masked", mm)
    k1, merge = f"{fam}_fwd", f"{fam}_fwd_merge"
    counters = ((k1, mod, "launches"), (merge, mod, "fwd_merge_launches"),
                ("flash_fwd", fa, "launches"))
    read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_paths(params).values())
    engine = ServeEngine(cfg, params, masks=masks, pack=pack, **HYMBA_ENGINE)
    torch.cuda.synchronize()
    print(f"{label}: hymba-1.5b ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, ssm {cfg.ssm_d_inner} x "
          f"{cfg.ssm_state}, {n_params / 1e9:.3f} B parameters, {4 * n_params / 1e9:.2f} GB "
          f"f32) initialised in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    if sorted(engine.pools) != ["global", "local"]:
        raise AssertionError(f"{label}: page pools {sorted(engine.pools)}")
    for r in staggered_requests(cfg, 2, prompt_lens=(20,), gen_lens=(2,), seed=1):
        engine.submit(r)
    engine.run()

    n_req, lens, gen = HYMBA_REQUESTS[kernel]
    reqs = staggered_requests(cfg, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
    engine = ServeEngine(cfg, engine.params, masks=masks, pack=pack, **HYMBA_ENGINE)
    for r in reqs:
        engine.submit(r)
    for _, m_, a in counters:
        setattr(m_, a, 0)
    stats = engine.run()
    launches = read()
    for r in reqs:
        if r.status is not Status.DONE or len(r.generated) != gen:
            raise AssertionError(f"{label}: request {r.rid}: {r.status} with "
                                 f"{len(r.generated)} tokens")
    if stats["quarantined"] or stats["failed"]:
        raise AssertionError(f"{label}: quarantined/failed slots: {stats}")
    engine.check_pool_accounting()
    if any(p.n_live for p in engine.pools.values()):
        raise AssertionError(f"{label}: pages left live after the run")
    per_call = HYMBA_PROJ * cfg.n_layers
    st = {"params": engine.params, "pack": pack, "masks": masks}
    dec = leaf_merges(torch, cfg, st, HYMBA_ENGINE["capacity"], 0, "fwd")[0]
    pre = {r.prompt_len: leaf_merges(torch, cfg, st, r.prompt_len, 0, "fwd")[0] for r in reqs}
    expect = {k1: per_call * (stats["decode_steps"] + stats["prefills"]),
              merge: stats["decode_steps"] * dec + sum(pre[r.prompt_len] for r in reqs),
              "flash_fwd": cfg.n_layers * stats["prefills"]}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, expected {expect}")

    # one decode step at capacity, slot 0 inactive: exact launches, and the
    # inactive slot's SSM state bit for bit (every table is the sentinel
    # after the run, so the KV writes drop)
    dev = engine.device
    tok = torch.from_numpy(engine.cur_tok[:, None]).to(dev)
    pos = torch.from_numpy(engine.pos).to(dev)
    tables = {g: torch.from_numpy(t).to(dev) for g, t in engine.tables.items()}
    active = torch.tensor([False, True, True, True], device=dev)
    before = [{k: v[0].clone() for k, v in c["ssm"].items()} for c in engine.caches]
    c0 = read()
    lm_decode(engine.params, cfg, engine.caches, tok, pos, masks=masks, pack=pack,
              active=active, tables=tables)
    step = {n: v - c0[n] for n, v in read().items()}
    want_step = {k1: per_call, merge: dec, "flash_fwd": 0}
    if step != want_step:
        raise AssertionError(f"{label}: one decode step launched {step}, expected {want_step}")
    frozen = all(torch.equal(c["ssm"][k][0], v)
                 for c, b in zip(engine.caches, before) for k, v in b.items())
    if not frozen:
        raise AssertionError(f"{label}: an inactive slot's SSM state changed in a decode step")
    del before

    # one prompt's prefill profiled: the flash kernels it runs
    toks = torch.from_numpy(reqs[1].tokens).long().cuda()[None]
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        lm_prefill(engine.params, cfg, {"tokens": toks}, HYMBA_ENGINE["max_len"], masks=masks,
                   pack=pack)
        torch.cuda.synchronize()
    _, _, names = trace_busy(prof, ROOT / "build" / f"hymba_serve_{kernel}_trace.json")
    flash = flash_kernels_of(names)
    if flash != [HYMBA_FLASH[0]]:
        raise AssertionError(f"{label}: the prefill ran the flash kernels {flash}")
    stats.update({"prefill_ms": 1e3 * stats["prefill_s"] / stats["prefills"],
                  "decode_step_ms": 1e3 * stats["decode_step_s"],
                  "launches_per_decode_step": step, "merges_per_prefill": {
                      str(p): m for p, m in pre.items()}, "prefill_flash_kernels": flash,
                  "parameters": n_params, "inactive_slot_frozen": frozen,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

    # the plain dense path on the same weights: the first 4 requests'
    # greedy streams (every prompt length among them), and two prompts'
    # prefill logits
    dense = dataclasses.replace(cfg, sparse=dataclasses.replace(
        cfg.sparse, kernel="dense", attn_kernel="dense"))
    dreqs = staggered_requests(cfg, 4, prompt_lens=lens, gen_lens=(gen,), seed=0)
    dengine = ServeEngine(dense, engine.params, **HYMBA_ENGINE)
    for r in dreqs:
        dengine.submit(r)
    dengine.run()
    same = sum(a == b for r, d in zip(reqs, dreqs) for a, b in zip(r.generated, d.generated))
    agree = same / sum(len(d.generated) for d in dreqs)
    errs, gaps = [], []
    V = cfg.vocab_size
    for r in reqs[:2]:
        toks = torch.from_numpy(r.tokens).long().cuda()[None]
        a = lm_prefill(engine.params, cfg, {"tokens": toks}, r.prompt_len, masks=masks,
                       pack=pack)[0].float()[..., :V]
        b = lm_prefill(engine.params, dense, {"tokens": toks}, r.prompt_len)[0].float()[..., :V]
        if not bool(torch.isfinite(a).all()) or a.shape != (1, 1, V):
            raise AssertionError(f"{label}: prefill logits not finite or of the wrong shape")
        errs.append((a - b).abs().max().item() / b.abs().max().item())
        top = b.flatten().topk(2).values
        gaps.append((top[0] - top[1]).item())
    stats["vs_dense"] = {"token_agreement": agree, "streams_equal": sum(
        r.generated == d.generated for r, d in zip(reqs, dreqs)), "requests": len(dreqs),
        "prefill_logits_rel_err_max": max(errs), "logits_tol": HYMBA_LOGITS_TOL,
        "dense_top2_gap_min": min(gaps)}
    print(f"{label}: vs the plain dense path:", json.dumps(stats["vs_dense"]))
    if max(errs) > HYMBA_LOGITS_TOL or agree < 0.9:
        raise AssertionError(f"{label}: kernel path vs dense path: {stats['vs_dense']}")
    del dengine
    stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode, label)
    print(f"{label}: engine", json.dumps({k: stats[k] for k in (
        "requests", "tokens", "decode_steps", "prefills", "wall_s", "tok_per_s",
        "prefill_ms", "decode_step_ms", "decode_step_device_ms", "peak_gib")}),
          f"launches {launches}; a decode step {step}")
    if bs:
        cases = k1_served_cases(torch, timer, bsm, engine, rows=(4, max(lens)),
                                names=HYMBA_CASES)
    else:
        proj = [(n, *n.split(".")) for n in HYMBA_CASES]
        cases = masked_cases(torch, timer, mm, engine.params, masks, proj=proj,
                             bn=HYMBA_BLOCK, fused=False)
    return stats, launches, cases


def hymba_train(torch, timer, bsm, mm, fa, kernel):
    """Phase "hymba train": ``model_train`` on ``HYMBA_TRAIN``."""
    return model_train(torch, timer, bsm, mm, fa, kernel, HYMBA_TRAIN)


def model_train(torch, timer, bsm, mm, fa, kernel, spec):
    """Train a model at full width and ``spec``'s depth under ``kernel``,
    as the hymba phase does (``spec``: the same keys for gemma3 and
    command-r).  Hymba: train hymba-1.5b at full width, 4 of 32 layers (layer 0 global,
    1-3 local; ~285 M parameters with the tied table), ERK 0.8, RigL with
    the Top-KAST superset (Δ = 10%), Adam, warmup-cosine, seed 0, under
    ``kernel`` (block_sparse in 64x64 blocks, or masked), 1 x 2048 tokens
    (past the window, one SSM chunk), 4 steps, a drop/grow at step 2.
    First the step-0 loss and the gradients of layers/0/ssm/in_proj,
    layers/1/ssm/out_proj, layers/0/attn/wq, the dense layers/1/ssm/w_dt,
    layers/0/ssm/a_log and the tied table against the plain dense path;
    then ``train_loop`` with every counter set to 0 just before it: finite
    losses and the exact launches of every step (remat reruns each block's
    forward: 2 x 36 K1 (K13), 36 K2 and K3 (K14, K15), 8 K9, 4 K10, 4 K11;
    the planned split merges of each), the profiled step running only the
    exact d = 64 flash instantiations, and after the update the counts
    kept, B ⊇ A and the pack (carrier) fresh.  Reports step s, tok/s, peak
    GiB, the profiled step's busy share.  Under block_sparse first K2 and
    K3 on layer 0's packs and supersets at ``HYMBA_CASES``' projections
    (``bs_bwd_cases``): returns (stats, launches, its cases or None).
    ``spec`` without ``cases`` runs no K2/K3 cases; with ``update`` False
    the run makes no drop/grow (its checks are left out); ``opt`` is the
    run's optimizer (``train_loop``'s default Adam when None)."""
    from repro_torch.core.masks import block_mask_of, tree_paths
    from repro_torch.core.pack import pack_entries, pack_mismatch, pack_np, validate_pack
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    bs = kernel == "block_sparse"
    label = f"{spec['label']} {kernel}"
    cfg = spec["config"](kernel, spec["layers"])
    if not spec["update"]:  # no drop/grow within the run
        cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                                  delta_t=10 * spec["steps"]))
    steps, batch, S = spec["steps"], spec["batch"], spec["seq"]
    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_paths(state["params"]).values())
    cases = (bs_bwd_cases(torch, timer, bsm, pack_np, state, cfg, names=spec["cases"],
                          uniform=False) if bs and spec["cases"] else None)
    dense_check = train_dense_check(torch, cfg, state, label=label, batch=batch, seq=S,
                                    names=spec["grads"])
    fam = "block_sparse" if bs else "masked"
    mod = bsm if bs else mm
    fw = 2 if cfg.remat else 1  # remat reruns each block's forward in the backward

    def merges_of(st):
        """(fwd, dx, dw) split merges of one step on ``st``'s pack."""
        return tuple((fw if e == "fwd" else 1) * leaf_merges(torch, cfg, st, batch * S, 0, e)[0]
                     for e in ("fwd", "dx", "dw"))

    first = merges_of(state)
    del state
    torch.cuda.empty_cache()
    counters = ((f"{fam}_fwd", mod, "launches"), (f"{fam}_dx", mod, "dx_launches"),
                (f"{fam}_dw", mod, "dw_launches"),
                (f"{fam}_fwd_merge", mod, "fwd_merge_launches"),
                (f"{fam}_dx_merge", mod, "dx_merge_launches"),
                (f"{fam}_dw_merge", mod, "dw_merge_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"))
    read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
    proj, n_l = spec["proj"] * cfg.n_layers, cfg.n_layers

    def expected(m):
        return {f"{fam}_fwd": fw * proj, f"{fam}_dx": proj, f"{fam}_dw": proj,
                f"{fam}_fwd_merge": m[0], f"{fam}_dx_merge": m[1], f"{fam}_dw_merge": m[2],
                "flash_fwd": fw * n_l, "flash_dq": n_l, "flash_dkv": n_l}

    log = []
    mark = {"counts": None, "t": None, "units": None, "prof": None, "merges": first}

    def units(masks):
        return {n: (block_mask_of(m, cfg.sparse.block_shape) if bs else m)
                for n, m in tree_paths(masks).items()}

    def on_step(step, is_update, st, met):
        torch.cuda.synchronize()
        t = time.perf_counter()
        counts = read()
        prev = mark["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "update": is_update, "loss": float(met["loss"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if mark["t"] is not None:
            rec["wall_s"] = t - mark["t"]
        # the step ran on the pack it left unless it updated the topology
        want = expected(mark["merges"] if is_update else merges_of(st))
        if rec["launches"] != want:
            raise AssertionError(f"{label} step {step}: launches {rec['launches']}, "
                                 f"expected {want}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{label} step {step}: loss {rec['loss']}")
        mark["merges"] = merges_of(st)
        if step == 1:
            mark["units"] = {n: u.cpu() for n, u in units(st["masks"]).items()}
        if step == steps - 1:
            mark["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            mark["prof"].__enter__()
        elif step == steps:
            mark["prof"].__exit__(None, None, None)
        print(f"{label}:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        if spec.get("empty_cache"):  # the step's freed transients, back to the card
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mark.update(counts=counts, t=time.perf_counter())

    for _, m_, a in counters:
        setattr(m_, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tag = spec["label"].replace(" ", "_")
    state, _ = train_loop(cfg, steps=steps, batch=batch, seq=S, opt_cfg=spec["opt"],
                          workdir=str(ROOT / "chiprun_out" / f"{tag}_{kernel}"),
                          device="cuda", on_step=on_step, log_every=steps, ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()
    after, bwd = units(state["masks"]), units(state["bwd_masks"])
    moved = 0
    for n, u in after.items() if spec["update"] else ():
        before = mark["units"][n]
        if int(u.sum()) != int(before.sum()):
            raise AssertionError(f"{label}: {n}: {int(before.sum())} active units before "
                                 f"the update, {int(u.sum())} after")
        if (u & ~bwd[n]).any():
            raise AssertionError(f"{label}: {n}: the superset does not contain the mask")
        moved += int((u.cpu() & ~before).sum())
    if moved == 0 and spec["update"]:
        raise AssertionError(f"{label}: the drop/grow moved nothing")
    if bs:
        validate_pack(state["pack"], where=f"chip_smoke {spec['label']}")
        stale = int(pack_mismatch(state["masks"], state["pack"], cfg.sparse.block_shape,
                                  bwd_masks=state["bwd_masks"]))
        if stale:
            raise AssertionError(f"{label}: pack stale after the update: {stale} blocks")
    else:
        carried = dict(pack_entries(state["pack"]))
        bw = tree_paths(state["bwd_masks"])
        if sorted(carried) != sorted(bw) or any(carried[n]["bwd_mask"] is not bw[n]
                                                for n in bw):
            raise AssertionError(f"{label}: the carrier does not hold the refreshed superset")
    del state
    torch.cuda.empty_cache()
    busy_ms, top, names = trace_busy(mark["prof"],
                                     ROOT / "build" / f"{tag}_{kernel}_trace.json")
    flash = flash_kernels_of(names)
    if flash != sorted(spec["flash"]):
        raise AssertionError(f"{label}: the profiled step ran the flash kernels {flash}")
    steady = [r for r in log if "wall_s" in r and not r["update"] and r["step"] != steps]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    profiled = log[-1]
    stats = {
        "layers": cfg.n_layers, "parameters": n_params, "steps": steps,
        "tokens_per_step": batch * S, "total_s": total_s, "mean_train_step_wall_s": wall,
        "steady_steps": [r["step"] for r in steady], "tok_per_s": batch * S / wall,
        "update_step_wall_s": [r.get("wall_s") for r in log if r["update"]],
        "peak_gib": max(r["peak_gib"] for r in log),
        "profiled_step_wall_s": profiled["wall_s"],
        "profiled_step_device_busy_ms": busy_ms or None,
        "profiled_step_busy_share": busy_ms / 1e3 / profiled["wall_s"] if busy_ms else None,
        "profiled_step_top": top, "profiled_step_flash_kernels": flash,
        "losses": [r["loss"] for r in log], "launches_per_step": [r["launches"] for r in log],
        "units_moved": moved, "step0_vs_dense": dense_check,
    }
    share = stats["profiled_step_busy_share"]
    print(f"{label}: {cfg.name} {cfg.n_layers} of {spec['of']} layers ({n_params / 1e6:.1f} M "
          f"parameters), {steps} steps of {batch} x {S} tokens in {total_s:.1f} s; train step "
          f"{wall:.3f} s wall (mean of {len(steady)}) = {stats['tok_per_s']:.0f} tok/s; peak "
          f"{stats['peak_gib']:.1f} GiB; profiled step busy {busy_ms:.1f} ms of "
          f"{profiled['wall_s']:.3f} s ({'not measured' if share is None else f'{share:.1%}'}); "
          f"{moved} {'blocks' if bs else 'weights'} moved by the drop/grow; launches "
          f"{launches}")
    return stats, launches, cases


HYMBA_FLASH_CASES = (("S=2048 window=1024 (local layers)", 2048, 1024),
                     ("S=2048 global (layers 0, 15, 31)", 2048, 0))


def hymba_flash_cases(torch, timer, fa):
    """K9, K10 and K11 at hymba's attention (25 query heads over 5 KV
    heads, G = 5, head_dim 64, bf16, S = 2048: a local layer's window 1024
    and a global layer), each on the exact d = 64 instantiation against its
    plain version (element by element within ``fa.o_error_bound`` and
    ``fa.grad_error_bound``), timed beside three yardsticks: the generic
    instantiation it replaces (also held to the bound), PyTorch's
    scaled_dot_product_attention with the same mask (its backward for
    K10 and K11: dq, dk and dv together) and the bound; each with both
    instantiations' launches (CTAs an SM, registers, shared and spill
    bytes, warps).  The exact launches must not spill and must have the
    warps and CTAs an SM the backward plan counts on."""
    return flash_cases_at(torch, timer, fa, "hymba", 25, 5, 64, HYMBA_FLASH_CASES)


def flash_cases_at(torch, timer, fa, model, BH, G, d, cases, generic=True, sweep=False,
                   softcap=0.0):
    """K9, K10 and K11 of ``model``'s attention (BH query heads over
    BH / G, head_dim d, bf16) at ``cases`` ((name, S, window): causal, or
    (name, S, window, causal)), as ``hymba_flash_cases`` says; without
    ``generic`` (d = 256: no generic instantiation) the generic yardstick
    is left out.  A length S the blocks do not divide runs on the layout
    ``flash_attention`` pads it to: zero query and key rows past S, the
    padded keys masked (sk = S) and zero dO on the padded query rows (the
    wrapper's trim); the wrapper itself is then run too, forward and
    backward by autograd on the S rows, and its gradients held to the
    plain version on the padded layout (dk and dv take nothing from the
    padded query rows only if the trim gives them zero dO).  With
    ``sweep`` each K10 / K11 case also times every candidate plan of
    ``fa.bwd_plan`` (``plan_sweep``) and says whether its pick was the
    fastest, with the launch (``bwd_launch``).  SDPA runs on the S rows
    (no mask for a bidirectional case).  ``softcap`` caps the scores in
    the kernels and the plain versions (SDPA has no softcap: its time is
    the same work less the tanh)."""
    from repro_torch.core.attn_sched import sched_for

    F = torch.nn.functional
    BKV = BH // G
    k9, k10, k11 = [], [], []
    for kind in ("dq", "dkv"):
        info = fa.launch_info(f"flash_{kind}", d, 8)
        if (info["spill_bytes"] or info["ctas_per_sm"] != fa.bwd_ctas_per_sm(kind, d)
                or info["warps"] != fa.bwd_warps(kind, d)):
            raise AssertionError(f"flash_{kind} at d = {d}: launch {info} against the plan's "
                                 f"{fa.bwd_warps(kind, d)} warps, "
                                 f"{fa.bwd_ctas_per_sm(kind, d)} CTAs an SM")
    insts = (("exact", False), ("generic", True)) if generic else (("exact", False),)
    for case_spec in cases:
        name, S, window = case_spec[:3]
        causal = case_spec[3] if len(case_spec) > 3 else True
        r = lambda n: torch.randn(n, S, d, device="cuda").to(torch.bfloat16)
        q_, k_, v_, do_ = r(BH), r(BKV), r(BKV), r(BH)
        bq, bk = fa.effective_blocks(S, S)
        Sp = -(-S // bq) * bq
        pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
        q, k, v, do = pad(q_), pad(k_), pad(v_), pad(do_)
        sched = fa._schedule_on(q.device, S, S, bq, bk, causal, window, 0)
        sched_np = sched_for(S, S, bq, bk, causal, window, 0)
        width = int(sched_np["kv_idx"].shape[1])
        kw = dict(bq=bq, bk=bk, causal=causal, window=window, q_offset=0, sk=S,
                  scale=d**-0.5, softcap=softcap, kv_groups=G)
        pos = torch.arange(S, device="cuda")
        mask = torch.ones(S, S, dtype=torch.bool, device="cuda")
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        live = int(mask.sum())
        tag = f"{model} {name} BH={BH} G={G} d={d}" + (f" softcap={softcap}" if softcap else "")
        q4, k4, v4 = (t.view(1, -1, S, d).detach().requires_grad_(True) for t in (q_, k_, v_))
        attn_mask = mask if (causal or window) else None
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask,
                                                      enable_gqa=True)

        # K9
        fwd_args = (q, k, v, sched[0], sched[1])
        po, plse = fa.flash_attention_plain(*fwd_args, **kw)
        pa, _ = fa.flash_attention_plain(q, k, v.abs(), sched[0], sched[1], **kw)
        bound = fa.o_error_bound(po, pa)
        checks = {}
        for inst, gen in insts:
            o, lse = fa.flash_fwd(*fwd_args, generic=gen, **kw)
            diff = (o.float() - po.float()).abs()
            ratio = (diff / bound.clamp_min(1e-30)).max().item()
            err_l = (lse - plse).abs().max().item()
            if not (bool((diff <= bound).all()) and err_l <= 1e-3):
                raise AssertionError(f"K9 {tag} ({inst}): o {ratio:.3g}x its bound, "
                                     f"lse err {err_l}")
            checks[inst] = (diff.max().item(), ratio, err_l)
        flops = 4.0 * d * live * BH
        b_ms, by = bound_ms(2 * (2 * BH * S * d + 2 * BKV * S * d) + 4 * BH * S, flops)
        ms = timer(lambda: fa.flash_fwd(*fwd_args, **kw), reps=5)
        case = {"case": tag, "max_abs_err": checks["exact"][0],
                "err_over_tol": checks["exact"][1], "lse_err": checks["exact"][2], "ms": ms,
                "plain_ms": timer(lambda: fa.flash_attention_plain(*fwd_args, **kw),
                                  reps=2, warmup=1),
                "library_ms": timer(sdpa, reps=5), "bound_ms": b_ms, "bound_by": by,
                "tflop_s": flops / ms / 1e9, "share_of_bound": b_ms / ms,
                "launch": fa.launch_info("flash_fwd", d, width)}
        if generic:
            case.update(generic_err_over_tol=checks["generic"][1],
                        generic_ms=timer(lambda: fa.flash_fwd(*fwd_args, generic=True, **kw),
                                         reps=5),
                        generic_launch=fa.launch_info("flash_fwd", d, width, generic=True))
        if case["launch"]["spill_bytes"]:
            raise AssertionError(f"K9 {tag}: the launch spills: {case['launch']}")
        print("K9", json.dumps(case))
        k9.append(case)

        # K10, K11
        o, lse = fa.flash_fwd(*fwd_args, **kw)
        delta = (do.float() * o.float()).sum(-1)
        dq_args = (q, k, v, do, lse, delta, sched[0], sched[1])
        dkv_args = (q, k, v, do, lse, delta, sched[2], sched[3])
        blocks = fa._schedule_mask(sched[0], sched[1], Sp // bk, q.device)
        plain_args = (q, k, v, do, lse, delta, blocks)
        want_q, want_k, want_v, rq, rk, rv, eq, ek, ev = fa.flash_bwd_plain(
            *plain_args, with_abs=True, **kw)
        wants = {"dq": (want_q, rq, eq), "dk": (want_k, rk, ek), "dv": (want_v, rv, ev)}
        wrapper = None
        if Sp != S:  # the wrapper pads, trims and differentiates itself
            leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
            o_w = fa.flash_attention(*leaves, causal=causal, window=window, kv_groups=G)
            got_w = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(o_w, leaves, do_)))
            wrapper = {}
            for w_, (want, rnd, err) in wants.items():
                ok, ratio, _ = within(torch, got_w[w_], want[:, :S],
                                      fa.grad_error_bound(want, rnd, err)[:, :S])
                if not ok:
                    raise AssertionError(f"flash_attention {tag} {w_}: {ratio:.3g}x its bound")
                wrapper[w_] = ratio
            for w_, t in (("dk", want_k), ("dv", want_v)):  # the padded keys take nothing
                if t[:, S:].abs().max().item() != 0.0:
                    raise AssertionError(f"{tag}: a padded key row took a gradient in {w_}")
            del leaves, o_w, got_w
        out4 = sdpa()
        lib_ms = timer(lambda: torch.autograd.grad(out4, (q4, k4, v4), do_.view(1, BH, S, d),
                                                   retain_graph=True), reps=5)
        plain_ms = timer(lambda: fa.flash_bwd_plain(*plain_args, **kw), reps=2, warmup=1)
        for kernel, kind, fn, args, what, n_bytes, flops in (
                ("K10", "dq", fa.flash_dq, dq_args, ("dq",),
                 2 * (3 * BH * S * d + 2 * BKV * S * d) + 8 * BH * S, 6.0 * d * live * BH),
                ("K11", "dkv", fa.flash_dkv, dkv_args, ("dk", "dv"),
                 2 * (2 * BH * S * d + 4 * BKV * S * d) + 8 * BH * S, 8.0 * d * live * BH)):
            checks = {}
            for inst, gen in insts:
                got = fn(*args, generic=gen, **kw)
                got = dict(zip(what, (got,) if kind == "dq" else got))
                worst = (0.0, 0.0)
                for w_ in what:
                    want, rnd, err = wants[w_]
                    ok, ratio, _ = within(torch, got[w_], want,
                                          fa.grad_error_bound(want, rnd, err))
                    if not ok:
                        raise AssertionError(f"{kernel} {tag} ({inst}) {w_}: {ratio:.3g}x "
                                             "its bound")
                    worst = max(worst, ((got[w_].float() - want.float()).abs().max().item(),
                                        ratio), key=lambda t: t[1])
                checks[inst] = worst
            b_ms, by = bound_ms(n_bytes, flops)
            ms = timer(lambda: fn(*args, **kw), reps=5)
            case = {"case": tag, "max_abs_err": checks["exact"][0],
                    "err_over_tol": checks["exact"][1], "ms": ms,
                    "plain_ms": plain_ms, "plain_covers": "dq, dk and dv",
                    "library_ms": lib_ms, "library_covers": "dq, dk and dv",
                    "bound_ms": b_ms, "bound_by": by, "tflop_s": flops / ms / 1e9,
                    "share_of_bound": b_ms / ms,
                    "launch": fa.launch_info(f"flash_{kind}", d, width)}
            if generic:
                case.update(generic_err_over_tol=checks["generic"][1],
                            generic_ms=timer(lambda: fn(*args, generic=True, **kw), reps=5),
                            generic_launch=fa.launch_info(f"flash_{kind}", d, width,
                                                          generic=True))
            if wrapper is not None:
                case["wrapper_err_over_tol"] = {w_: wrapper[w_] for w_ in what}
            if sweep:
                plan = bwd_launch(torch, fa, kind, sched_np, kw, BH if kind == "dq" else BKV,
                                  d, Sp)
                plans = plan_sweep(timer, fa, fn, args, kw)
                mine = f"pair={int(plan['pair'])} split={plan['n_split']}"
                case.update(plan=plan, plans_ms=plans,
                            plan_is_fastest=plans[mine] == min(plans.values()))
            print(kernel, json.dumps(case))
            (k10 if kernel == "K10" else k11).append(case)
        del out4
    return k9, k10, k11


GEMMA_FLASH_CASES = (("S=2048 window=1024 (local layers)", 2048, 1024),
                     ("S=2048 global (every 6th layer)", 2048, 0))


def gemma_flash_cases(torch, timer, fa):
    """Phase "flash d = 256": K9, K10 and K11 at gemma3-4b's attention (8
    query heads over 4 KV heads, G = 2, head_dim 256, bf16, S = 2048: a
    local layer's window 1024 and a global layer) on their exact d = 256
    instantiations, each against its plain version within
    ``fa.o_error_bound`` / ``fa.grad_error_bound`` (the tolerances of the
    d = 128 and d = 64 checks), timed beside PyTorch's
    scaled_dot_product_attention (forward; forward and backward for K10 and
    K11) and the operations bound, with each launch's CTAs an SM,
    registers, shared and spill bytes (no spill allowed)."""
    return flash_cases_at(torch, timer, fa, "gemma3", 8, 2, 256, GEMMA_FLASH_CASES,
                          generic=False)


# ---------------------------------------------------------------------------
# gemma3-4b (qk-norm, sandwich norms, GeGLU, 5:1 local:global, head_dim 256)
# and command-r-plus-104b (parallel blocks, tied 256000-row table)
# ---------------------------------------------------------------------------

GEMMA_ENGINE = dict(capacity=4, max_len=2048, page_size=16)
GEMMA_PROJ = 7  # K1/K13 a layer a pass: wq, wk, wv, wo, wi, wg, wo
# (requests, prompt lengths, new tokens): the 1400-token prompts wrap the
# local layers' 1024-slot rings
GEMMA_REQUESTS = (3, (300, 1400), 16)
GEMMA_FLASH = ("flash_fwd_kernel<256, true>", "flash_dq_kernel<256, true>",
               "flash_dkv_kernel<256, true>")
CMDR_FLASH = ("flash_fwd_kernel<128, true>", "flash_dq_kernel<128, true>",
              "flash_dkv_kernel<128, true>")


def full_width_config(arch, kernel, n_layers=None):
    """``arch`` at its published widths (full depth unless ``n_layers``),
    ERK 0.8, flash_tight; block_sparse in 128x128 blocks, or masked; RigL
    with the Top-KAST superset every ``DELTA_T`` steps in one
    microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config(arch), kernel=kernel, block=128,
                           attn_kernel="flash_tight")
    sp = dataclasses.replace(cfg.sparse, method="rigl", delta_t=DELTA_T)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers, microbatches=1,
                               sparse=sp)


def command_r_config(kernel="block_sparse", n_layers=PAGED_LAYERS):
    """command-r-plus-104b at its published widths, ``n_layers`` of 64
    deep (the f32 masters of all 64, 416 GB, fit no card), ERK 0.8,
    block_sparse in 128x128 blocks, flash_tight; RigL with the Top-KAST
    superset in one microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("command-r-plus-104b"), kernel=kernel, block=128,
                           attn_kernel="flash_tight")
    sp = dataclasses.replace(cfg.sparse, method="rigl", delta_t=DELTA_T)
    return dataclasses.replace(cfg, n_layers=n_layers, microbatches=1, sparse=sp)


def model_serve(torch, timer, bsm, mm, fa, spec):
    """Serve ``spec``'s model at full width and depth (gemma3-4b,
    internvl2-1b) through the engine under block_sparse (128x128 blocks:
    K1) and masked (K13) on one init's weights and block-aligned masks
    (ERK 0.8, seed 0), in each of ``spec["layouts"]`` (paged or
    contiguous): ``spec["requests"]`` staggered greedy requests (a patch
    config's each carry their seeded patch rows).  Checks, per mode and
    layout: every request DONE, nothing quarantined, a paged engine's
    pools (``spec["pools"]``) and books clean; the run's launches exactly
    ``proj`` x layers K1 (K13) a prefill and a decode step plus the merges
    the plans make (a prefill's at its bucket's rows plus its patch rows)
    and a K9 a layer and prompt; one prefill and one decode step counted
    on their own; the profiled prefill on ``spec["flash"]`` alone; every
    greedy token equal to the plain dense path's on the same weights and
    requests (kernel='dense', attn_kernel='dense').  With
    ``spec["k1_cases"]`` ((names, rows)), K1 on layer 0's served packs of
    the first block-sparse engine under every candidate plan.  Reports the
    prefill ms per request, the decode step's host and device ms.
    Returns ({"parameters": n, mode and layout: (stats, launches)}, K1
    cases)."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.launch.serve import (
        configure_kernel,
        init_serving_state,
        staggered_requests,
    )
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    name, eng_kw, layouts = spec["label"], spec["engine"], spec["layouts"]
    cfg_bs = full_width_config(spec["arch"], "block_sparse")
    P = cfg_bs.n_patches if cfg_bs.frontend == "patch" else 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg_bs, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_paths(params).values())
    torch.cuda.synchronize()
    print(f"{name}: {spec['arch']} ({cfg_bs.n_layers} layers, d_model {cfg_bs.d_model}, "
          f"{cfg_bs.n_heads}/{cfg_bs.n_kv_heads} heads of {cfg_bs.head_dim}, d_ff "
          f"{cfg_bs.d_ff}, {n_params / 1e9:.3f} B parameters, {4 * n_params / 1e9:.2f} GB "
          f"f32) initialised in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    n_req, lens, gen = spec["requests"]
    dense = dataclasses.replace(cfg_bs, sparse=dataclasses.replace(
        cfg_bs.sparse, kernel="dense", attn_kernel="dense"))
    dreqs = staggered_requests(dense, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
    dengine = ServeEngine(dense, params, paged=layouts[0], **eng_kw)
    for r in dreqs:
        dengine.submit(r)
    dengine.run()
    del dengine
    out = {"parameters": n_params}
    k1_cases = []
    per_call = spec["proj"] * cfg_bs.n_layers
    for kernel in ("block_sparse", "masked"):
        bs = kernel == "block_sparse"
        cfg = cfg_bs if bs else configure_kernel(cfg_bs, kernel="masked")
        pk = pack if bs else None
        fam, mod = ("block_sparse", bsm) if bs else ("masked", mm)
        k1, merge = f"{fam}_fwd", f"{fam}_fwd_merge"
        counters = ((k1, mod, "launches"), (merge, mod, "fwd_merge_launches"),
                    ("flash_fwd", fa, "launches"))
        read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
        warm = ServeEngine(cfg, params, masks=masks, pack=pk, paged=layouts[0], **eng_kw)
        for r in staggered_requests(cfg, 2, prompt_lens=(20,), gen_lens=(2,), seed=1):
            warm.submit(r)
        warm.run()
        served = warm.params
        del warm
        for paged in layouts:
            key = f"{kernel} paged" if paged else kernel
            label = f"{name} {key}"
            engine = ServeEngine(cfg, served, masks=masks, pack=pk, paged=paged, **eng_kw)
            if paged and spec["pools"] and sorted(engine.pools) != spec["pools"]:
                raise AssertionError(f"{label}: page pools {sorted(engine.pools)}")
            reqs = staggered_requests(cfg, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
            for r in reqs:
                engine.submit(r)
            for _, m_, a in counters:
                setattr(m_, a, 0)
            stats = engine.run()
            launches = read()
            for r in reqs:
                if r.status is not Status.DONE or len(r.generated) != gen:
                    raise AssertionError(f"{label}: request {r.rid}: {r.status} with "
                                         f"{len(r.generated)} tokens")
            if stats["quarantined"] or stats["failed"]:
                raise AssertionError(f"{label}: quarantined/failed slots: {stats}")
            if paged:
                engine.check_pool_accounting()
                if any(p.n_live for p in engine.pools.values()):
                    raise AssertionError(f"{label}: pages left live after the run")
            st = {"params": engine.params, "pack": pk, "masks": masks}
            dec = leaf_merges(torch, cfg, st, eng_kw["capacity"], 0, "fwd")[0]
            # a prefill runs the prompt padded to its bucket, and its patch rows
            pre = {L: leaf_merges(torch, cfg, st, engine._padded_len(L) + P, 0, "fwd")[0]
                   for L in set(lens)}
            expect = {k1: per_call * (stats["decode_steps"] + stats["prefills"]),
                      merge: stats["decode_steps"] * dec + sum(pre[r.prompt_len]
                                                               for r in reqs),
                      "flash_fwd": cfg.n_layers * stats["prefills"]}
            if launches != expect:
                raise AssertionError(f"{label}: launches {launches}, expected {expect}")

            # one prefill (profiled: the flash kernels it runs) and one decode
            # step at capacity, each counted on its own
            r1 = reqs[1]
            inputs = {"tokens": torch.from_numpy(r1.tokens).long().cuda()[None]}
            if P:
                inputs["patches"] = torch.from_numpy(r1.patches).cuda()[None]
            c0 = read()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                lm_prefill(engine.params, cfg, inputs, eng_kw["max_len"], masks=masks, pack=pk)
                torch.cuda.synchronize()
            one_prefill = {n: v - c0[n] for n, v in read().items()}
            want_pre = {k1: per_call,
                        merge: leaf_merges(torch, cfg, st, r1.prompt_len + P, 0, "fwd")[0],
                        "flash_fwd": cfg.n_layers}
            if one_prefill != want_pre:
                raise AssertionError(f"{label}: one prefill launched {one_prefill}, "
                                     f"expected {want_pre}")
            tag = label.replace(" ", "_")
            _, _, names = trace_busy(prof, ROOT / "build" / f"{tag}_trace.json")
            flash = flash_kernels_of(names)
            if flash != [spec["flash"]]:
                raise AssertionError(f"{label}: the prefill ran the flash kernels {flash}")
            dev = engine.device
            c0 = read()
            lm_decode(engine.params, cfg, engine.caches,
                      torch.from_numpy(engine.cur_tok[:, None]).to(dev),
                      torch.from_numpy(engine.pos).to(dev), masks=masks, pack=pk,
                      tables=({g: torch.from_numpy(t).to(dev) for g, t in engine.tables.items()}
                              if paged else None))
            one_step = {n: v - c0[n] for n, v in read().items()}
            want_step = {k1: per_call, merge: dec, "flash_fwd": 0}
            if one_step != want_step:
                raise AssertionError(f"{label}: one decode step launched {one_step}, "
                                     f"expected {want_step}")
            same = [r.generated == d.generated for r, d in zip(reqs, dreqs)]
            agree = sum(a == b for r, d in zip(reqs, dreqs)
                        for a, b in zip(r.generated, d.generated)) / (n_req * gen)
            stats.update({"prefill_ms": 1e3 * stats["prefill_s"] / stats["prefills"],
                          "decode_step_ms": 1e3 * stats["decode_step_s"],
                          "launches_per_prefill": one_prefill,
                          "launches_per_decode_step": one_step,
                          "merges_per_prefill": {str(p): m for p, m in pre.items()},
                          "prefill_flash_kernels": flash, "streams_equal_dense": same,
                          "token_agreement_dense": agree,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            print(f"{label}: vs the plain dense path: streams equal {same}, token agreement "
                  f"{agree:.3f}")
            if not all(same):
                raise AssertionError(f"{label}: greedy streams differ from the dense path's: "
                                     f"{[r.generated for r in reqs]} vs "
                                     f"{[d.generated for d in dreqs]}")
            stats["decode_step_device_ms"] = decode_device_ms(torch, engine, lm_decode, label)
            print(f"{label}: engine", json.dumps({k: stats[k] for k in (
                "requests", "tokens", "decode_steps", "prefills", "wall_s", "tok_per_s",
                "prefill_ms", "decode_step_ms", "decode_step_device_ms", "peak_gib")}),
                  f"launches {launches}; a prefill {one_prefill}; a decode step {one_step}")
            out[key] = (stats, launches)
            if bs and spec["k1_cases"] and not k1_cases:
                names_, rows = spec["k1_cases"]
                k1_cases = k1_served_cases(torch, timer, bsm, engine, rows=rows, names=names_)
            del engine
            torch.cuda.empty_cache()
    return out, k1_cases


GEMMA_SERVE = dict(label="gemma3 serve", arch="gemma3-4b", engine=GEMMA_ENGINE, layouts=(True,),
                   requests=GEMMA_REQUESTS, proj=GEMMA_PROJ, flash=GEMMA_FLASH[0],
                   pools=["global", "local"], k1_cases=None)


def gemma_serve(torch, timer, bsm, mm, fa):
    """Phase "gemma3 serve": ``model_serve`` on gemma3-4b at full width and
    depth (34 layers: 5 local (window 1024) to 1 global, qk-norm, sandwich
    norms, GeGLU, head_dim 256, the tied 262144-row table; ~3.9 B
    parameters) through the paged engine (a local ring pool and a global
    pool of 16-token pages; capacity 4, max_len 2048): 3 requests (prompts
    300/1400, 16 tokens; the 1400-token prompts wrap the local rings);
    exactly 238 K1 (K13) a prefill and a decode step (34 x 7 projections)
    plus the planned merges, 34 K9 a prompt, the profiled prefill on the
    exact d = 256 K9 alone, every greedy token the dense path's."""
    return model_serve(torch, timer, bsm, mm, fa, GEMMA_SERVE)[0]


GEMMA_TRAIN = dict(label="gemma3 train",
                   config=lambda k, n: full_width_config("gemma3-4b", k, n), layers=6, of=34,
                   proj=GEMMA_PROJ, steps=4, batch=1, seq=2048,
                   grads=("layers/0/mlp/wi/w", "layers/5/attn/wq/w",
                          "layers/0/attn/q_norm/scale", "layers/5/ln2_post/scale",
                          "embed/table"),
                   flash=GEMMA_FLASH, cases=None, update=True, opt=None)


def gemma_train(torch, timer, bsm, mm, fa, kernel):
    """Phase "gemma3 train": ``model_train`` on gemma3-4b at full width, 6
    of 34 layers (one 5:1 period: layers 0-4 local, 5 global; ~1.2 B
    parameters with the tied table), 1 x 2048 tokens, 4 steps with a
    drop/grow at step 2, Adam: the step-0 loss and gradients of an MLP
    and a global layer's wq, a qk-norm and a post-norm scale and the tied
    table against the plain dense path; exact launches a step (remat: 2 x
    42 K1 (K13), 42 K2 and K3 (K14, K15), 12 K9, 6 K10 and K11 and the
    planned merges); the profiled step on the d = 256 flash kernels
    alone."""
    return model_train(torch, timer, bsm, mm, fa, kernel, GEMMA_TRAIN)


def command_r_train(torch, timer, bsm, mm, fa):
    """Phase "command-r train": ``model_train`` on command-r-plus-104b at
    full width, 1 of 64 layers (1.57 B parameters beside the tied 256000 x
    12288 table's 3.15 B), block_sparse, SGD with momentum 0.9 and no
    weight decay, 1 x 512 tokens, 3 steps and no drop/grow: the step-0
    loss and gradients of the MLP's wi, the attention's wq and ln1 against
    the plain dense path; exact launches a step; the profiled step on the
    d = 128 flash kernels alone.  The weights and their gradients are 2 x
    18.9 GB; the momentum is kept in bf16 (``OptConfig.state_dtype``, as
    grok-1's config keeps it): with an f32 momentum the first step peaked
    at 73.9 GiB of the card's 79.2 and the second found the 11.7 GiB the
    table's gradient takes too fragmented.  The update and the gradient
    norm take the table in row chunks (``optimizers._row_chunks``), and
    the cached allocator blocks go back to the card between steps."""
    from repro_torch.optim.optimizers import OptConfig

    spec = dict(label="command-r train", config=command_r_config, layers=1, of=64,
                proj=GEMMA_PROJ, steps=3, batch=1, seq=512,
                grads=("layers/0/mlp/wi/w", "layers/0/attn/wq/w", "layers/0/ln1/scale"),
                flash=CMDR_FLASH, cases=None, update=False, empty_cache=True,
                opt=OptConfig(kind="sgd", momentum=0.9, weight_decay=0.0,
                              state_dtype="bfloat16"))
    return model_train(torch, timer, bsm, mm, fa, "block_sparse", spec)


# ---------------------------------------------------------------------------
# the frontend families: hubert-xlarge (an encoder on frames, bidirectional
# attention, plain GELU) and internvl2-1b (patch prompts in the engine)
# ---------------------------------------------------------------------------

HUBERT_FRAMES = 4096  # one encode and a train microbatch: 1 x 4096 frames
HUBERT_PROJ = 6  # K1/K13 a layer a pass: wq, wk, wv, wo, wi, wo
HUBERT_FLASH = ("flash_fwd_kernel<80, true>", "flash_dq_kernel<80, true>",
                "flash_dkv_kernel<80, true>")
# the encode's kernel path against the plain dense path on the same weights,
# both in bf16 through 48 layers: logits within this share of the largest,
# and the frames' argmax labels agreeing at least this often
HUBERT_LOGITS_TOL, HUBERT_ARGMAX_MIN = 5e-2, 0.9
# K9-K11 at hubert's attention (16 heads, G = 1, d = 80, bidirectional): the
# model's 4096 frames, and a length 128-row blocks do not divide (1000 -> 1024)
HUBERT_FLASH_CASES = (("S=4096 bidirectional", 4096, 0, False),
                      ("S=1000 bidirectional (padded to 1024)", 1000, 0, False))
INTERNVL_FLASH_CASES = (("S=2048 causal (256 patches + 1792 text)", 2048, 0),)
INTERNVL_ENGINE = dict(capacity=4, max_len=2048, page_size=16)
INTERNVL_PROJ = 7  # K1/K13 a layer a pass: wq, wk, wv, wo, wi, wg, wo
# (requests, text prompt lengths, new tokens); each request carries 256 patch
# rows: 1200 text tokens bucket to the cap 2048 - 256
INTERNVL_REQUESTS = (8, (100, 600, 1200), 16)
INTERNVL_FLASH = ("flash_fwd_kernel<64, true>", "flash_dq_kernel<64, true>",
                  "flash_dkv_kernel<64, true>")


def frontend_flash_cases(torch, timer, fa):
    """Phase "flash frontends": K9, K10 and K11 at hubert-xlarge's
    bidirectional attention (16 heads, G = 1, head_dim 80, bf16,
    ``causal=0``: the model's S = 4096 frames, and S = 1000 on the padded
    1024-row layout, where the padded query rows see every real key and the
    wrapper's trim must give them zero dO) and at internvl2-1b's causal
    attention (14 query heads over 2, G = 7, head_dim 64, S = 2048), each on
    its exact instantiation against its plain version within
    ``fa.o_error_bound`` / ``fa.grad_error_bound``, timed beside the generic
    instantiation, scaled_dot_product_attention and the bound; hubert's
    K10 and K11 also under every candidate plan of ``fa.bwd_plan`` (its
    non-causal walks all have one length), the padded case through the
    wrapper too (``flash_cases_at``)."""
    hub = flash_cases_at(torch, timer, fa, "hubert", 16, 1, 80, HUBERT_FLASH_CASES,
                         sweep=True)
    ivl = flash_cases_at(torch, timer, fa, "internvl", 14, 7, 64, INTERNVL_FLASH_CASES)
    return {"hubert": dict(zip(("k9", "k10", "k11"), hub)),
            "internvl": dict(zip(("k9", "k10", "k11"), ivl))}


def hubert_encode(torch, bsm, mm, fa):
    """Phase "hubert encode": the encoder's inference path (the reference
    has no decode for it).  hubert-xlarge at full width and depth (48
    layers, 16 heads of 80, d_ff 5120, plain GELU; the frames frontend,
    ERK 0.8, seed 0), ``lm_forward`` and the head on 1 x 4096 seeded frames
    (``frames_batch``), under block_sparse (128x128 blocks: K1) and masked
    (K13) on one init's weights and block-aligned masks, with the launch
    counters set to 0 just before each: exactly 288 K1 (K13), their planned
    split merges and 48 bidirectional K9 a forward.  Each mode's logits
    against the plain dense path on the same weights (kernel='dense',
    attn_kernel='dense'; the whole encoder in bf16 on both): finite, the
    largest difference within ``HUBERT_LOGITS_TOL`` of the largest logit,
    the frames' argmax labels agreeing at least ``HUBERT_ARGMAX_MIN`` of the
    time.  The engine, ``serve_session`` and ``lm_prefill`` refuse the
    encoder.  Reports the encode's wall ms, its ms between CUDA events
    around it (the device's work and the host's launch gaps) and frames a
    second."""
    from repro_torch.core.masks import tree_paths
    from repro_torch.data.synthetic import frames_batch
    from repro_torch.launch.serve import configure_kernel, init_serving_state, serve_session
    from repro_torch.models.model import _logits, lm_forward, lm_prefill, serving_weights
    from repro_torch.serving.engine import ServeEngine

    cfg_bs = full_width_config("hubert-xlarge", "block_sparse")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg_bs, seed=0, device="cuda")
    n_params = sum(t.numel() for t in tree_paths(params).values())
    torch.cuda.synchronize()
    print(f"hubert encode: hubert-xlarge ({cfg_bs.n_layers} layers, d_model "
          f"{cfg_bs.d_model}, {cfg_bs.n_heads} heads of {cfg_bs.head_dim}, d_ff "
          f"{cfg_bs.d_ff}, {n_params / 1e9:.3f} B parameters) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    for what, call in (
            ("ServeEngine", lambda: ServeEngine(cfg_bs, params, capacity=1, max_len=64,
                                                masks=masks, pack=pack)),
            ("serve_session", lambda: serve_session(cfg_bs, params, batch=1, prompt_len=8,
                                                    gen=2, masks=masks, pack=pack)),
            ("lm_prefill", lambda: lm_prefill(params, cfg_bs, {"frames": torch.zeros(
                1, 8, cfg_bs.frontend_dim, device="cuda")}, 16, masks=masks, pack=pack))):
        try:
            call()
        except ValueError as e:
            print(f"hubert encode: {what} refuses the encoder: {e}")
        else:
            raise AssertionError(f"hubert encode: {what} accepted an encoder config")
    batch = {"frames": frames_batch(cfg_bs, 0, 1, HUBERT_FRAMES, device="cuda")["frames"]}
    dense = dataclasses.replace(cfg_bs, sparse=dataclasses.replace(
        cfg_bs.sparse, kernel="dense", attn_kernel="dense"))
    w = serving_weights(params, cfg_bs)
    V = cfg_bs.vocab_size

    def encode(cfg, **kw):
        with torch.no_grad():
            h, _, _ = lm_forward(w, cfg, batch, collect_states=False, **kw)
            return _logits(w, cfg, h)[..., :V]

    want = encode(dense)
    top = want.abs().max().item()
    out = {"parameters": n_params, "frames": HUBERT_FRAMES}
    for kernel in ("block_sparse", "masked"):
        bs = kernel == "block_sparse"
        label = f"hubert encode {kernel}"
        cfg = cfg_bs if bs else configure_kernel(cfg_bs, kernel="masked")
        kw = dict(masks=masks, pack=pack if bs else None)
        fam, mod = ("block_sparse", bsm) if bs else ("masked", mm)
        counters = ((f"{fam}_fwd", mod, "launches"),
                    (f"{fam}_fwd_merge", mod, "fwd_merge_launches"),
                    ("flash_fwd", fa, "launches"))
        read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
        encode(cfg, **kw)  # plans and schedules built
        torch.cuda.synchronize()
        for _, m_, a in counters:
            setattr(m_, a, 0)
        t0 = time.perf_counter()
        a_ev, b_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a_ev.record()
        got = encode(cfg, **kw)
        b_ev.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = read()
        st = {"params": params, "pack": pack, "masks": masks}
        expect = {f"{fam}_fwd": HUBERT_PROJ * cfg.n_layers,
                  f"{fam}_fwd_merge": leaf_merges(torch, cfg, st, HUBERT_FRAMES, 0, "fwd")[0],
                  "flash_fwd": cfg.n_layers}
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: non-finite logits")
        err = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        stats = {"launches": launches, "wall_ms": wall_ms,
                 "events_ms": a_ev.elapsed_time(b_ev),
                 "frames_per_s": HUBERT_FRAMES / wall_ms * 1e3,
                 "logits_max_abs_err": err, "logits_max_abs": top,
                 "logits_err_over_largest": err / top, "logits_tol": HUBERT_LOGITS_TOL,
                 "argmax_agreement": agree, "argmax_agreement_min": HUBERT_ARGMAX_MIN,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"{label}:", json.dumps(stats))
        if not (err <= HUBERT_LOGITS_TOL * top and agree >= HUBERT_ARGMAX_MIN):
            raise AssertionError(f"{label}: logits {err / top:.3g} of the largest "
                                 f"(tol {HUBERT_LOGITS_TOL}), argmax agreement {agree:.4f} "
                                 f"(min {HUBERT_ARGMAX_MIN}) against the dense path")
        out[kernel] = (stats, launches)
    del w, params, masks, pack
    torch.cuda.empty_cache()
    return out


HUBERT_TRAIN = dict(label="hubert train",
                    config=lambda k, n: full_width_config("hubert-xlarge", k, n), layers=8, of=48,
                    proj=HUBERT_PROJ, steps=4, batch=1, seq=HUBERT_FRAMES,
                    grads=("layers/0/mlp/wi/w", "layers/7/attn/wq/w", "frontend_proj/w",
                           "head/w"),
                    flash=HUBERT_FLASH, cases=None, update=True, opt=None)


def hubert_train(torch, timer, bsm, mm, fa, kernel):
    """Phase "hubert train": ``model_train`` on hubert-xlarge at full
    width, 8 of 48 layers (~170 M parameters), 1 x 4096 frames in one
    microbatch, 4 steps with a drop/grow at step 2, Adam: the step-0 loss
    and gradients of an MLP's wi, a layer's wq, the dense frontend_proj
    and head against the plain dense path; exact launches a step (remat:
    2 x 48 K1 (K13), 48 K2 and K3 (K14, K15), 16 bidirectional K9, 8 K10
    and K11, and the planned merges); the profiled step on the d = 80 flash
    kernels alone."""
    return model_train(torch, timer, bsm, mm, fa, kernel, HUBERT_TRAIN)


INTERNVL_SERVE = dict(label="internvl serve", arch="internvl2-1b", engine=INTERNVL_ENGINE,
                      layouts=(False, True), requests=INTERNVL_REQUESTS, proj=INTERNVL_PROJ,
                      flash=INTERNVL_FLASH[0], pools=["global"],
                      k1_cases=(("attn.wq", "mlp.wi"), (16, 2048)))


def internvl_serve(torch, timer, bsm, mm, fa):
    """Phase "internvl serve": ``model_serve`` on internvl2-1b at full width
    and depth (24 layers, 14 query heads over 2 KV heads of 64, d_ff 4864,
    the tied 151808-row table), contiguous and paged (16-token pages;
    capacity 4, max_len 2048): 8 requests, each with 256 seeded patch rows
    in front of a text prompt of 100, 600 or 1200 tokens, 16 tokens each;
    exactly 168 K1 (K13) a prefill and a decode step (24 x 7 projections)
    plus the planned merges (a prefill's at its bucket's rows plus the 256
    patch rows), 24 K9 a prompt, the profiled prefill on the exact d = 64
    K9 alone, every greedy token the dense path's; then K1 on layer 0's
    served packs at d_model 896 (7 K-blocks) under every candidate plan at
    a decode step's 16 rows and a prefill's 2048."""
    return model_serve(torch, timer, bsm, mm, fa, INTERNVL_SERVE)


INTERNVL_TRAIN = dict(label="internvl train",
                      config=lambda k, n: full_width_config("internvl2-1b", k, n), layers=24, of=24,
                      proj=INTERNVL_PROJ, steps=4, batch=1, seq=2048,
                      grads=("layers/0/mlp/wi/w", "layers/23/attn/wq/w", "frontend_proj/w",
                             "embed/table"),
                      flash=INTERNVL_FLASH, cases=None, update=True, opt=None)


def internvl_train(torch, timer, bsm, mm, fa, kernel):
    """Phase "internvl train": ``model_train`` on internvl2-1b at full width
    and depth (24 layers, ~0.49 B parameters with the tied table), 1 x 2048
    rows a step (256 seeded patch rows and 1792 text tokens, ``vlm_batch``;
    the loss over the text), 4 steps with a drop/grow at step 2, Adam: the
    step-0 loss and gradients of an MLP's wi, the last layer's wq, the
    dense frontend_proj and the tied table against the plain dense path;
    exact launches a step (remat: 2 x 168 K1 (K13), 168 K2 and K3 (K14,
    K15), 48 K9, 24 K10 and K11, and the planned merges); the profiled step
    on the d = 64 flash kernels alone."""
    return model_train(torch, timer, bsm, mm, fa, kernel, INTERNVL_TRAIN)


# ---------------------------------------------------------------------------
# grok-1-314b: bf16 masters, the f32 MoE over 1.61 G-element bf16 expert
# banks (8 experts top-2, moe_d_ff 32768), the attention and final softcaps;
# K9-K11 at d = 128, G = 6 with softcap 30
# ---------------------------------------------------------------------------

GROK_SERVE_LAYERS = 4  # of 64: 42.6 GB of bf16 masters and 19.7 GB of masks
GROK_TRAIN_LAYERS = 1  # of 64: with its state and one microbatch's gradients ~75 GB
GROK_PROJ = 4  # K1/K13 a layer a pass: wq, wk, wv, wo
GROK_BANKS = 3  # K4/K16 a layer a pass: wi, wg, wo
GROK_ENGINE = dict(capacity=4, max_len=2048, paged=True, page_size=16)
GROK_REQUESTS = (8, (100, 400, 1000), 32)  # requests, prompt lengths, new tokens
GROK_FLASH_CASES = (("S=1024 causal", 1024, 0), ("S=2048 causal", 2048, 0))
GROK_SOFTCAP = 30.0
GROK_FLASH = ("flash_dkv_kernel<128, true>", "flash_dq_kernel<128, true>",
              "flash_fwd_kernel<128, true>")
# the step-0 gradients held against the plain dense path: the banks, the
# router, an attention projection and the head, all bf16 leaves
GROK_GRAD_LEAVES = ("layers/0/moe/wi/w", "layers/0/moe/wo/w", "layers/0/moe/router/w",
                    "layers/0/attn/wq/w", "head/w")
GROK_TRAIN = dict(steps=3, batch=16, seq=1024)  # 16 microbatches of 1 x 1024
GROK_BANK_ROWS = 320  # a 1024-token microbatch's expert capacity (top-2 of 8, x1.25)


def grok_config(kernel, n_layers, microbatches=1):
    """grok-1-314b at its published widths, ``n_layers`` of 64 deep (its
    bf16 masters, 628 GB at full depth, fit no card), ERK 0.8, flash_tight;
    block_sparse in 128x128 blocks, or masked; RigL with the Top-KAST
    superset."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import configure_kernel

    cfg = configure_kernel(get_config("grok-1-314b"), kernel=kernel, block=128,
                           attn_kernel="flash_tight")
    sp = dataclasses.replace(cfg.sparse, method="rigl", delta_t=DELTA_T)
    return dataclasses.replace(cfg, n_layers=n_layers, microbatches=microbatches, sparse=sp)


def grok_flash_cases(torch, timer, fa):
    """Phase "grok flash": K9, K10 and K11 at grok-1-314b's attention (48
    query heads over 8, G = 6, head_dim 128, bf16, causal, the logit
    softcap 30 applied in the kernels) at S = 1024 and 2048, on the d = 128
    instantiation and the generic one, each against its plain version
    within ``fa.o_error_bound`` / ``fa.grad_error_bound``, timed beside
    SDPA (which has no softcap: its time is the same work less the tanh)
    and the operations bound (``flash_cases_at``)."""
    return flash_cases_at(torch, timer, fa, "grok", 48, 6, 128, GROK_FLASH_CASES,
                          softcap=GROK_SOFTCAP)


def grok_merges(torch, cfg, state, rows, entry):
    """Split merges of one pass over a grok stack's dispatched leaves: the
    attention's 2-D projections at ``rows`` rows and the expert banks at
    their capacity for ``rows`` tokens (``leaf_merges``)."""
    from repro_torch.models.moe import capacity

    return sum(leaf_merges(torch, cfg, state, rows, capacity(rows, cfg), entry))


def bank_casts_ms(torch, timer, params):
    """Device time of the bf16 -> f32 casts of every expert bank of
    ``params`` (one decode step's, or one forward's, upcasts), each copy
    freed before the next, as in the kernels' Functions."""
    banks = [lp["moe"][b]["w"] for lp in params["layers"] for b in ("wi", "wg", "wo")]

    def casts():
        for w in banks:
            w.to(torch.float32)

    return timer(casts, reps=3, warmup=1)


def grok_serve(torch, timer, bsm, mm, fa):
    """Phase "grok serve": grok-1-314b at full width, 4 of 64 layers (4.92 B
    parameters a layer, the untied 131072-row embedding and head; 20.5 B
    in bf16 masters), one init's masters and block-aligned masks (ERK 0.8,
    128x128 blocks, seed 0) through the paged engine (capacity 4, max_len
    2048, 16-token pages), under block_sparse (K1 for the attention, K4
    for the banks) and masked (K13, K16).  Checks, per mode: 8 staggered
    greedy requests (prompts 100/400/1000, 32 tokens) all DONE, nothing
    quarantined, clean pool books; the run's launches exactly 4 x 4 K1
    (K13) and 3 x 4 K4 (K16) a prefill and a decode step plus the planned
    merges, 4 K9 a prompt; one prefill and one decode step counted on
    their own; the profiled prefill on the d = 128 K9 alone; the greedy
    tokens against the plain dense path on the same masters (their
    agreement reported, at least 50%: a routing near-tie flips a stream
    from that token on), routing and logits against it by ``moe_vs_dense``
    (at least 95% of the (token, layer) top-2 sets agree; the agreeing
    prompts' logits within 2e-2 of the largest).  The prefix cache is
    refused (an MoE config).  Block-sparse also holds K1 and K4 on layer
    0's wq and wi without a pack entry (the mask packed on the call) bit
    for bit to the calls with the entry.  Reports prefill ms, the decode
    step's host ms, its profiled busy ms, the bank casts' ms within it
    and peak GiB."""
    import numpy as np
    from repro_torch.core.masks import tree_paths
    from repro_torch.launch.serve import (
        configure_kernel,
        init_serving_state,
        staggered_requests,
    )
    from repro_torch.models.model import lm_decode, lm_prefill
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.queue import Status

    cfg_bs = grok_config("block_sparse", GROK_SERVE_LAYERS)
    L = cfg_bs.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, masks, pack = init_serving_state(cfg_bs, seed=0, device="cuda")
    leaves = tree_paths(params)
    n_params = sum(t.numel() for t in leaves.values())
    dtypes = sorted({str(t.dtype) for t in leaves.values()})
    torch.cuda.synchronize()
    print(f"grok serve: grok-1-314b ({L} of 64 layers, d_model {cfg_bs.d_model}, "
          f"{cfg_bs.n_heads}/{cfg_bs.n_kv_heads} heads of {cfg_bs.head_dim}, "
          f"{cfg_bs.n_experts} experts top-{cfg_bs.top_k} of {cfg_bs.moe_d_ff}, "
          f"{n_params / 1e9:.3f} B parameters, {dtypes}) initialised in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} "
          "GiB on the card")
    if dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"grok serve: masters in {dtypes}, not bf16")
    try:
        ServeEngine(cfg_bs, params, masks=masks, pack=pack, prefix_cache=2, **GROK_ENGINE)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("grok serve: the prefix cache was not refused for an MoE config")
    n_req, lens, gen = GROK_REQUESTS
    dense = dataclasses.replace(cfg_bs, sparse=dataclasses.replace(
        cfg_bs.sparse, kernel="dense", attn_kernel="dense"))
    dreqs = staggered_requests(dense, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
    dengine = ServeEngine(dense, params, **GROK_ENGINE)
    for r in dreqs:
        dengine.submit(r)
    dengine.run()
    del dengine
    torch.cuda.empty_cache()
    out = {"parameters": n_params, "prefix_cache_refused": refused}
    per_call = {"proj": GROK_PROJ * L, "bank": GROK_BANKS * L}
    for kernel in ("block_sparse", "masked"):
        bs = kernel == "block_sparse"
        label = f"grok serve {kernel}"
        cfg = cfg_bs if bs else configure_kernel(cfg_bs, kernel="masked")
        pk = pack if bs else None
        fam, mod = ("block_sparse", bsm) if bs else ("masked", mm)
        k1, k4, merge = f"{fam}_fwd", f"grouped_{fam}_fwd", f"{fam}_fwd_merge"
        counters = ((k1, mod, "launches"), (k4, mod, "g_launches"),
                    (merge, mod, "fwd_merge_launches"), ("flash_fwd", fa, "launches"))
        read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
        warm = ServeEngine(cfg, params, masks=masks, pack=pk, **GROK_ENGINE)
        for r in staggered_requests(cfg, 2, prompt_lens=(20,), gen_lens=(2,), seed=1):
            warm.submit(r)
        warm.run()
        del warm
        engine = ServeEngine(cfg, params, masks=masks, pack=pk, **GROK_ENGINE)
        reqs = staggered_requests(cfg, n_req, prompt_lens=lens, gen_lens=(gen,), seed=0)
        for r in reqs:
            engine.submit(r)
        for _, m_, a in counters:
            setattr(m_, a, 0)
        torch.cuda.reset_peak_memory_stats()
        stats = engine.run()
        launches = read()
        for r in reqs:
            if r.status is not Status.DONE or len(r.generated) != gen:
                raise AssertionError(f"{label}: request {r.rid}: {r.status} with "
                                     f"{len(r.generated)} tokens")
        if stats["quarantined"] or stats["failed"]:
            raise AssertionError(f"{label}: quarantined/failed slots: {stats}")
        engine.check_pool_accounting()
        if any(p.n_live for p in engine.pools.values()):
            raise AssertionError(f"{label}: pages left live after the run")
        st = {"params": engine.params, "pack": pk, "masks": masks}
        cap = GROK_ENGINE["capacity"]
        dec = grok_merges(torch, cfg, st, cap, "fwd")
        pre = {n: grok_merges(torch, cfg, st, engine._padded_len(n), "fwd") for n in set(lens)}
        calls = stats["decode_steps"] + stats["prefills"]
        expect = {k1: per_call["proj"] * calls, k4: per_call["bank"] * calls,
                  merge: stats["decode_steps"] * dec + sum(pre[r.prompt_len] for r in reqs),
                  "flash_fwd": L * stats["prefills"]}
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")

        r1 = reqs[1]
        inputs = {"tokens": torch.from_numpy(r1.tokens).long().cuda()[None]}
        c0 = read()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            lm_prefill(engine.params, cfg, inputs, GROK_ENGINE["max_len"], masks=masks,
                       pack=pk)
            torch.cuda.synchronize()
        one_prefill = {n: v - c0[n] for n, v in read().items()}
        want = {k1: per_call["proj"], k4: per_call["bank"],
                merge: grok_merges(torch, cfg, st, r1.prompt_len, "fwd"), "flash_fwd": L}
        if one_prefill != want:
            raise AssertionError(f"{label}: one prefill launched {one_prefill}, expected {want}")
        tag = label.replace(" ", "_")
        _, _, names = trace_busy(prof, ROOT / "build" / f"{tag}_prefill_trace.json")
        flash = flash_kernels_of(names)
        if flash != [GROK_FLASH[2]]:
            raise AssertionError(f"{label}: the prefill ran the flash kernels {flash}")
        dev = engine.device
        tables = {g: torch.from_numpy(t).to(dev) for g, t in engine.tables.items()}
        tok = torch.from_numpy(engine.cur_tok[:, None]).to(dev)
        pos = torch.from_numpy(engine.pos).to(dev)
        step = lambda: lm_decode(engine.params, cfg, engine.caches, tok, pos, masks=masks,
                                 pack=pk, tables=tables)
        c0 = read()
        step()
        one_step = {n: v - c0[n] for n, v in read().items()}
        want = {k1: per_call["proj"], k4: per_call["bank"], merge: dec, "flash_fwd": 0}
        if one_step != want:
            raise AssertionError(f"{label}: one decode step launched {one_step}, "
                                 f"expected {want}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            step()
            torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t1)
        busy_ms, top, _ = trace_busy(prof, ROOT / "build" / f"{tag}_decode_trace.json")
        casts_ms = bank_casts_ms(torch, timer, engine.params)
        same = [r.generated == d.generated for r, d in zip(reqs, dreqs)]
        agree = sum(a == b for r, d in zip(reqs, dreqs)
                    for a, b in zip(r.generated, d.generated)) / (n_req * gen)
        print(f"{label}: vs the plain dense path: streams equal {same}, token agreement "
              f"{agree:.3f}")
        if agree < 0.5:
            raise AssertionError(f"{label}: greedy tokens agree {agree:.3f} with the dense "
                                 "path's")
        rng = np.random.default_rng(7)
        probes = [rng.integers(0, cfg.vocab_size, 4) for _ in range(8)]
        stats.update({
            "prefill_ms": 1e3 * stats["prefill_s"] / stats["prefills"],
            "decode_step_ms": 1e3 * stats["decode_step_s"],
            "launches_per_prefill": one_prefill, "launches_per_decode_step": one_step,
            "merges_per_prefill": {str(n): m for n, m in pre.items()},
            "prefill_flash_kernels": flash, "streams_equal_dense": same,
            "token_agreement_dense": agree, "profiled_decode_step_ms": step_ms,
            "profiled_decode_step_busy_ms": busy_ms, "profiled_decode_step_top": top,
            "bank_casts_ms_per_decode_step": casts_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "vs_dense": moe_vs_dense(torch, cfg, engine.params, masks, pk,
                                     [r.tokens for r in reqs[:4]], probes, label)})
        if bs:
            stats["no_pack_entry"] = grok_no_pack_entry(torch, cfg, engine.params, masks, pack)
        print(f"{label}: engine", json.dumps({k: stats[k] for k in (
            "requests", "tokens", "decode_steps", "prefills", "wall_s", "tok_per_s",
            "prefill_ms", "decode_step_ms", "profiled_decode_step_ms",
            "profiled_decode_step_busy_ms", "bank_casts_ms_per_decode_step", "peak_gib")}),
              f"launches {launches}; a prefill {one_prefill}; a decode step {one_step}")
        out[kernel] = (stats, launches)
        del engine
        torch.cuda.empty_cache()
    return out


def grok_no_pack_entry(torch, cfg, params, masks, pack):
    """K1 on layer 0's wq and K4 on its wi bank through ``layers.linear`` /
    ``grouped_linear`` with the mask and no pack entry (packed on the call)
    against the same calls with the layer's entry: equal bit for bit."""
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.models import layers as L_

    lay, mk, pk = (t["layers"][0] for t in (params, masks, pack))
    blk = cfg.sparse.kernel_block
    x = torch.randn(16, cfg.d_model, device="cuda").to(torch.bfloat16)
    xb = torch.randn(cfg.n_experts, GROK_BANK_ROWS, cfg.d_model, device="cuda")
    out = {}
    with torch.no_grad():
        for name, fn, a, w, m, e in (
                ("K1 attn/wq", L_.linear, x, lay["attn"]["wq"], mk["attn"]["wq"]["w"],
                 pk["attn"]["wq"]["w"]),
                ("K4 moe/wi", L_.grouped_linear, xb, lay["moe"]["wi"]["w"],
                 mk["moe"]["wi"]["w"], pk["moe"]["wi"]["w"])):
            n1, g1 = bsm.launches, bsm.g_launches
            got = fn(w, a, None, mask=m, kernel="block_sparse", block=blk)
            ref = fn(w, a, None, mask=m, kernel="block_sparse", block=blk, pack=e)
            launched = (bsm.launches - n1, bsm.g_launches - g1)
            if not torch.equal(got, ref) or sum(launched) != 2:
                raise AssertionError(f"grok serve: {name} without a pack entry: equal "
                                     f"{torch.equal(got, ref)}, launches {launched}")
            out[name] = {"equal": True, "launches": launched}
    print("grok serve: no pack entry:", json.dumps(out))
    return out


def grok_bank_cases(torch, timer, bsm, mm):
    """Phase "grok banks": K4, K5 and K6, and K16, K17 and K18, each once
    on a whole grok expert bank (8 x 6144 x 32768 = 1,610,612,736
    elements, 75% of 2^31: the index widths), f32 as the path upcasts the
    bf16 master, at a 1024-token microbatch's capacity (320 rows, padded
    to 384), against its plain version (``matmul_error_bound``).  The
    block-sparse bank carries 20% of its 128x128 blocks and a 10% Top-KAST
    superset (K6's dense dw, 6.4 GB of f32, zero outside it); the masked
    one an elementwise 20% mask (K18 masked by it).  Timed beside
    torch.bmm on the zero-filled (pre-masked) bank and the bound."""
    import numpy as np
    from repro_torch.core.pack import pack_entry
    from repro_torch.kernels.ops import _row_tile

    G, K, N, C = 8, 6144, 32768, GROK_BANK_ROWS
    blk = 128
    f32 = torch.float32
    rng = np.random.default_rng(34)
    bm_np = rng.random((G, K // blk, N // blk)) < 0.2
    sup_np = bm_np | (rng.random(bm_np.shape) < 0.1)
    expand = lambda b: torch.from_numpy(b).cuda().repeat_interleave(blk, 1) \
        .repeat_interleave(blk, 2)
    mask_b, sup_b = expand(bm_np), expand(sup_np)
    e = pack_entry(mask_b, (blk, blk), bwd_mask=sup_b)
    del sup_b
    bm_, Mp = _row_tile(C, 128)
    w = torch.randn(G, K, N, device="cuda").to(torch.bfloat16).float() / K**0.5
    w.mul_(mask_b)
    x = torch.nn.functional.pad(torch.randn(G, C, K, device="cuda"), (0, 0, 0, Mp - C))
    g = torch.nn.functional.pad(torch.randn(G, C, N, device="cuda"), (0, 0, 0, Mp - C))
    nnz, bnnz = e["nnz"], e["bnnz"]
    out = {"K4": [], "K5": [], "K6": [], "K16": [], "K17": [], "K18": []}
    shape = f"G={G} C={C}->{Mp} K={K} N={N} ({G * K * N} elements)"
    es = 4

    def case(kernel, label, run, plain, library, absp, n, n_bytes, flops):
        want = plain()
        got = run()
        check = lambda: _check_within(torch, f"{kernel} {label}", got, want, absp(), n, f32)
        c = kernel_case(torch, timer, kernel, f"{kernel} grok bank {label} {shape}", run,
                        plain, library, check, n_bytes, flops, f32)
        out[kernel].append(c)
        del want, got
        torch.cuda.empty_cache()

    case("K4", f"blocks={nnz}",
         lambda: bsm.grouped_block_sparse_matmul(x, w, e["idx"], e["cnt"], bm=bm_, bn=blk,
                                                 bk=blk, live=nnz),
         lambda: bsm.grouped_block_sparse_matmul_plain(x, w, e["idx"], e["cnt"], blk, blk),
         lambda: torch.bmm(x, w),
         lambda: bsm.grouped_block_sparse_matmul_plain(x.abs(), w.abs(), e["idx"], e["cnt"],
                                                       blk, blk),
         K, es * (G * Mp * K + nnz * blk * blk + G * Mp * N), 2.0 * Mp * nnz * blk * blk)
    case("K5", f"blocks={nnz}",
         lambda: bsm.grouped_block_sparse_dx(g, w, e["ridx"], e["rcnt"], bm=bm_, bn=blk,
                                             bk=blk, live=nnz),
         lambda: bsm.grouped_block_sparse_dx_plain(g, w, e["ridx"], e["rcnt"], blk, blk),
         lambda: torch.bmm(g, w.transpose(1, 2)),
         lambda: bsm.grouped_block_sparse_dx_plain(g.abs(), w.abs(), e["ridx"], e["rcnt"],
                                                   blk, blk),
         N, es * (G * Mp * N + nnz * blk * blk + G * Mp * K), 2.0 * Mp * nnz * blk * blk)
    case("K6", f"superset blocks={bnnz}",
         lambda: bsm.grouped_block_sparse_dw(x, g, e["bidx"], e["bcnt"], bn=blk, bk=blk,
                                             live=bnnz),
         lambda: bsm.grouped_block_sparse_dw_plain(x, g, e["bidx"], e["bcnt"], blk, blk),
         lambda: torch.bmm(x.transpose(1, 2), g),
         lambda: bsm.grouped_block_sparse_dw_plain(x.abs(), g.abs(), e["bidx"], e["bcnt"],
                                                   blk, blk),
         Mp, es * (G * Mp * K + G * Mp * N + G * K * N), 2.0 * Mp * bnnz * blk * blk)
    del e, mask_b
    torch.cuda.empty_cache()
    m = torch.rand(G, K, N, device="cuda") < 0.2
    w.copy_(torch.randn(G, K, N, device="cuda").to(torch.bfloat16).float() / K**0.5)
    wm = w * m  # the library calls' pre-masked bank
    nm = int(m.sum())
    case("K16", f"elements={nm}",
         lambda: mm.grouped_masked_matmul(x, w, m, bm=bm_, bn=blk),
         lambda: mm.grouped_masked_matmul_plain(x, w, m),
         lambda: torch.bmm(x, wm),
         lambda: mm.grouped_masked_matmul_plain(x.abs(), w.abs(), m),
         K, es * (G * Mp * K + G * K * N + G * Mp * N) + G * K * N,
         2.0 * Mp * G * K * N)
    case("K17", f"elements={nm}",
         lambda: mm.grouped_masked_dx(g, w, m, bm=bm_, bk=blk),
         lambda: mm.grouped_masked_dx_plain(g, w, m),
         lambda: torch.bmm(g, wm.transpose(1, 2)),
         lambda: mm.grouped_masked_dx_plain(g.abs(), w.abs(), m),
         N, es * (G * Mp * N + G * K * N + G * Mp * K) + G * K * N,
         2.0 * Mp * G * K * N)
    case("K18", f"elements={nm}",
         lambda: mm.grouped_masked_dw(x, g, m, bn=blk, bk=blk),
         lambda: mm.grouped_masked_dw_plain(x, g, m),
         lambda: torch.bmm(x.transpose(1, 2), g) * m,
         lambda: mm.grouped_masked_dw_plain(x.abs(), g.abs(), m),
         Mp, es * (G * Mp * K + G * Mp * N + G * K * N) + G * K * N,
         2.0 * Mp * G * K * N)
    del w, wm, m, x, g
    torch.cuda.empty_cache()
    return out


def grok_train(torch, timer, bsm, mm, fa, kernel):
    """Phase "grok train": grok-1-314b at full width, 1 of 64 layers (4.92
    B parameters, and 1.61 B of embedding and head; all bf16 masters),
    ERK 0.8, RigL with the Top-KAST superset (elementwise under masked:
    its 1.61 G-element banks rank by ``rigl.select_top``), SGD with
    momentum 0.9 in a bf16 state and no weight decay, 16 x 1024 tokens in
    grok's 16 microbatches accumulated in bf16, 3 steps with no drop/grow
    inside them.  First, on the run's own initial state and before its
    optimizer state or accumulator exist, the step-0 loss of one 1 x 1024
    microbatch and the gradients of ``GROK_GRAD_LEAVES`` against the plain
    dense path (routing pinned; ``train_dense_check``'s 2e-2).  Then
    ``train_loop`` with every counter at 0: finite losses, exactly 16 x
    (2 x 4 K1, 4 K2, 4 K3, 2 x 3 K4, 3 K5, 3 K6, 2 K9, K10, K11) a step
    (remat reruns the forward; K13-K18 under masked) and 16 x the planned
    merges; every param and momentum leaf bf16 after the steps; step s,
    tok/s, peak GiB, the profiled last step's busy share.  Block-sparse
    then makes one drop/grow on a 1 x 1024 batch (``make_rigl_step``: the
    reference's one-pass backward, which at 16 x 1024 tokens would not fit
    beside the state) and ``refresh_pack``: the block counts kept, B ⊇ A,
    the pack fresh, blocks moved."""
    from repro_torch.core.masks import block_mask_of, tree_paths
    from repro_torch.core.pack import pack_mismatch, validate_pack
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import (
        init_train_state,
        make_algo,
        make_rigl_step,
        refresh_pack,
    )

    bs = kernel == "block_sparse"
    label = f"grok train {kernel}"
    steps, B, S = GROK_TRAIN["steps"], GROK_TRAIN["batch"], GROK_TRAIN["seq"]
    cfg = grok_config(kernel, GROK_TRAIN_LAYERS, microbatches=B)
    cfg = dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse,
                                                              delta_t=10 * steps))
    mb = cfg.microbatches
    opt = OptConfig(kind="sgd", momentum=0.9, weight_decay=0.0, state_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = init_train_state(cfg, opt, seed=0, device="cuda")
    del state["opt"]  # the check runs before any optimizer state exists
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_paths(state["params"]).values())
    dense_check = train_dense_check(torch, cfg, state, names=GROK_GRAD_LEAVES, label=label,
                                    batch=1, seq=S)
    fam = "block_sparse" if bs else "masked"
    mod = bsm if bs else mm
    per_mb = S * B // mb

    def merges_of(st):
        """(fwd, dx, dw) split merges of one microbatch on ``st``'s pack."""
        return tuple((2 if e == "fwd" else 1) * grok_merges(torch, cfg, st, per_mb, e)
                     for e in ("fwd", "dx", "dw"))

    merges = merges_of(state)
    del state
    torch.cuda.empty_cache()
    counters = ((f"{fam}_fwd", mod, "launches"), (f"{fam}_dx", mod, "dx_launches"),
                (f"{fam}_dw", mod, "dw_launches"), (f"grouped_{fam}_fwd", mod, "g_launches"),
                (f"grouped_{fam}_dx", mod, "gdx_launches"),
                (f"grouped_{fam}_dw", mod, "gdw_launches"),
                (f"{fam}_fwd_merge", mod, "fwd_merge_launches"),
                (f"{fam}_dx_merge", mod, "dx_merge_launches"),
                (f"{fam}_dw_merge", mod, "dw_merge_launches"),
                ("flash_fwd", fa, "launches"), ("flash_dq", fa, "dq_launches"),
                ("flash_dkv", fa, "dkv_launches"))
    read = lambda: {n: getattr(m_, a) for n, m_, a in counters}
    Lr = cfg.n_layers
    per = {f"{fam}_fwd": 2 * GROK_PROJ * Lr, f"{fam}_dx": GROK_PROJ * Lr,
           f"{fam}_dw": GROK_PROJ * Lr, f"grouped_{fam}_fwd": 2 * GROK_BANKS * Lr,
           f"grouped_{fam}_dx": GROK_BANKS * Lr, f"grouped_{fam}_dw": GROK_BANKS * Lr,
           f"{fam}_fwd_merge": merges[0], f"{fam}_dx_merge": merges[1],
           f"{fam}_dw_merge": merges[2], "flash_fwd": 2 * Lr, "flash_dq": Lr,
           "flash_dkv": Lr}
    want = {n: mb * v for n, v in per.items()}
    log, mark = [], {"counts": None, "t": None, "prof": None}

    def on_step(step, is_update, st, met):
        torch.cuda.synchronize()
        t = time.perf_counter()
        counts = read()
        prev = mark["counts"] or {n: 0 for n in counts}
        rec = {"step": step, "loss": float(met["loss"]),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {n: counts[n] - prev[n] for n in counts}}
        if mark["t"] is not None:
            rec["wall_s"] = t - mark["t"]
        if is_update or rec["launches"] != want:
            raise AssertionError(f"{label} step {step}: update {is_update}, launches "
                                 f"{rec['launches']}, expected {want}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{label} step {step}: loss {rec['loss']}")
        if step == steps - 1:
            mark["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            mark["prof"].__enter__()
        elif step == steps:
            mark["prof"].__exit__(None, None, None)
        print(f"{label}:", json.dumps(rec))
        log.append(rec)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mark.update(counts=counts, t=time.perf_counter())

    for _, m_, a in counters:
        setattr(m_, a, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tag = label.replace(" ", "_")
    state, _ = train_loop(cfg, steps=steps, batch=B, seq=S, opt_cfg=opt,
                          workdir=str(ROOT / "chiprun_out" / tag), device="cuda",
                          on_step=on_step, log_every=steps, ckpt_every=None)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read()
    bad = sorted(n for tree in (state["params"], state["opt"]["momentum"])
                 for n, t in tree_paths(tree).items() if t.dtype != torch.bfloat16)
    if bad:
        raise AssertionError(f"{label}: leaves not bf16 after the steps: {bad}")
    busy_ms, top, names = trace_busy(mark["prof"], ROOT / "build" / f"{tag}_trace.json")
    flash = flash_kernels_of(names)
    if flash != sorted(GROK_FLASH):
        raise AssertionError(f"{label}: the profiled step ran the flash kernels {flash}")
    steady = [r for r in log if "wall_s" in r and r["step"] != steps]
    wall = sum(r["wall_s"] for r in steady) / len(steady)
    profiled = log[-1]
    stats = {"layers": cfg.n_layers, "parameters": n_params, "init_s": init_s,
             "steps": steps, "microbatches": mb, "tokens_per_step": B * S,
             "total_s": total_s, "mean_train_step_wall_s": wall,
             "steady_steps": [r["step"] for r in steady], "tok_per_s": B * S / wall,
             "peak_gib": max(r["peak_gib"] for r in log),
             "profiled_step_wall_s": profiled["wall_s"],
             "profiled_step_device_busy_ms": busy_ms,
             "profiled_step_busy_share": busy_ms / 1e3 / profiled["wall_s"],
             "profiled_step_top": top, "profiled_step_flash_kernels": flash,
             "losses": [r["loss"] for r in log], "launches_per_microbatch": per,
             "step0_vs_dense": dense_check}
    if bs:  # one drop/grow on a 1 x 1024 batch
        lr = LRSchedule(base_lr=1e-3, warmup_steps=1, total_steps=10 * steps)
        units = lambda masks: {n: block_mask_of(m, cfg.sparse.block_shape)
                               for n, m in tree_paths(masks).items()}
        before = {n: u.cpu() for n, u in units(state["masks"]).items()}
        state = dict(state, step=DELTA_T)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, _ = make_rigl_step(cfg, make_algo(cfg, 10 * steps), lr)(
            state, batch_for(cfg, DELTA_T, 1, S, learnable=True, device="cuda"))
        state = refresh_pack(state, cfg)
        torch.cuda.synchronize()
        stats["update_step_wall_s"] = time.perf_counter() - t1
        stats["update_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        after, bwd = units(state["masks"]), units(state["bwd_masks"])
        moved = 0
        for n, u in after.items():
            u = u.cpu()
            if int(u.sum()) != int(before[n].sum()):
                raise AssertionError(f"{label}: {n}: {int(before[n].sum())} active blocks "
                                     f"before the update, {int(u.sum())} after")
            if (u & ~bwd[n].cpu()).any():
                raise AssertionError(f"{label}: {n}: the superset does not contain the mask")
            moved += int((u & ~before[n]).sum())
        validate_pack(state["pack"], where="chip_smoke grok train")
        stale = int(pack_mismatch(state["masks"], state["pack"], cfg.sparse.block_shape,
                                  bwd_masks=state["bwd_masks"]))
        if stale or not moved:
            raise AssertionError(f"{label}: after the update {stale} stale blocks, "
                                 f"{moved} moved")
        stats["blocks_moved"] = moved
    del state
    torch.cuda.empty_cache()
    print(f"{label}: grok-1-314b {cfg.n_layers} of 64 layers ({n_params / 1e9:.3f} B "
          f"parameters, bf16), {steps} steps of {B} x {S} tokens in {mb} microbatches in "
          f"{total_s:.1f} s; train step {wall:.3f} s wall = {stats['tok_per_s']:.0f} tok/s; "
          f"peak {stats['peak_gib']:.1f} GiB; profiled step busy {busy_ms:.1f} ms of "
          f"{profiled['wall_s']:.3f} s ({stats['profiled_step_busy_share']:.1%}); "
          f"{stats.get('blocks_moved', 'no')} blocks moved by the drop/grow; launches "
          f"{launches}")
    return stats, launches


def grok_phases(torch, timer, bsm, mm, fa, done):
    """Every grok phase, in order, each followed by ``done``: the flash
    cases, the whole-bank kernel cases, the serve (both modes) and the
    train (both modes).  Returns {"flash": (k9, k10, k11), "banks": cases,
    "serve": ..., "train block_sparse": ..., "train masked": ...}."""
    out = {"flash": grok_flash_cases(torch, timer, fa)}
    done("grok flash: K9-K11 at d = 128, G = 6, softcap 30")
    out["banks"] = grok_bank_cases(torch, timer, bsm, mm)
    done("grok banks: K4-K6, K16-K18 on a 1.61 G-element bank")
    out["serve"] = grok_serve(torch, timer, bsm, mm, fa)
    done("grok serve block_sparse, masked")
    for kernel in ("block_sparse", "masked"):
        out[f"train {kernel}"] = grok_train(torch, timer, bsm, mm, fa, kernel)
        done(f"grok train {kernel}")
    return out


# ---------------------------------------------------------------------------
# remat_policy='dots' and data parallelism over torch.distributed
# ---------------------------------------------------------------------------

REMAT_LAYERS, REMAT_ROWS = 4, 2  # danube at full width, 4 of 24 layers; 2 x 1024 tokens
DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")
DP_LAYERS, DP_STEPS, DP_BATCH = 4, 4, 8  # a drop/grow at step 2; 8 x 1024 global rows
DP_KERNELS = ("block_sparse_fwd", "block_sparse_dx", "block_sparse_dw", "flash_fwd",
              "flash_dq", "flash_dkv")


def remat_config(kernel, attn_kernel, policy, remat=True):
    """The train phase's danube at full width, 4 of 24 layers, one remat
    region a layer under ``policy``."""
    cfg = train_config()
    return dataclasses.replace(cfg, n_layers=REMAT_LAYERS, remat=remat, remat_group=1,
                               remat_policy=policy, sparse=dataclasses.replace(
                                   cfg.sparse, kernel=kernel, attn_kernel=attn_kernel))


def dot_counter(torch):
    """A dispatch mode counting the dense products (``DOT_OPS``) run
    under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in DOT_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    return Count()


def loss_grads(torch, cfg, params, batch, masks=None, pack=None, count=None):
    """(loss, [gradient of every leaf, on the host], s, peak GiB) of one
    ``lm_loss`` forward and backward (the gradients leave the card after
    the peak is read, so a run's peak holds no earlier run's); ``count``
    (a ``dot_counter``) wraps the backward alone."""
    import contextlib

    from repro_torch.core.masks import tree_map, tree_paths
    from repro_torch.models.model import lm_loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    src = tree_map(lambda _, t: t.detach().requires_grad_(True), params)
    loss = lm_loss(src, cfg, batch, masks=masks, pack=pack)
    with count or contextlib.nullcontext():
        grads = torch.autograd.grad(loss, list(tree_paths(src).values()))
    torch.cuda.synchronize()
    s, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    return loss.item(), [g.cpu() for g in grads], s, peak


def remat_phase(torch, bsm, fa):
    """``remat_policy='dots'`` against 'none' on danube at full width (4 of
    24 layers, 2 x 1024 tokens, one forward and backward each):

      block_sparse with flash_tight (K1-K3, K9-K11): the same launches
        under both policies (the forward kernels twice, the kernels opaque
        to the policy) and gradients equal bit for bit;
      kernel='dense' with flash_tight (cuBLAS projections saved, K9-K11
        recomputed) and with dense attention: gradients equal bit for bit,
        and the backward's dense products (a dispatch mode's count of
        mm/bmm/addmm/baddbmm) as many as without remat: no product is
        recomputed, where 'none' recomputes the forward's;

    with each run's seconds and peak GiB."""
    from repro_torch.core.masks import apply_masks
    from repro_torch.data.synthetic import batch_for
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    mods = {"bsm": bsm, "fa": fa}
    cfg = remat_config("block_sparse", "flash_tight", "none")
    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    batch = batch_for(cfg, 0, REMAT_ROWS, TRAIN_SEQ, learnable=True, device="cuda")
    n_proj, n_attn = 7 * cfg.n_layers, cfg.n_layers
    want = {"block_sparse_fwd": 2 * n_proj, "block_sparse_dx": n_proj,
            "block_sparse_dw": n_proj, "flash_fwd": 2 * n_attn, "flash_dq": n_attn,
            "flash_dkv": n_attn}
    stats, launches = {}, {}
    runs = {}
    for policy in ("none", "dots"):
        c = remat_config("block_sparse", "flash_tight", policy)
        loss_grads(torch, c, state["params"], batch, state["masks"], state["pack"])  # warm
        zero_counters(mods)
        loss, grads, s, peak = loss_grads(torch, c, state["params"], batch, state["masks"],
                                          state["pack"])
        launches[policy] = read_counters(mods)
        runs[policy] = grads
        stats[f"block_sparse {policy}"] = {"loss": loss, "s": s, "peak_gib": peak,
                                           "launches": launches[policy]}
    if launches["dots"] != launches["none"]:
        raise AssertionError(f"remat: launches under 'dots' {launches['dots']} differ "
                             f"from 'none' {launches['none']}")
    for name, n in want.items():
        if launches["dots"][name] != n:
            raise AssertionError(f"remat: {name} launched {launches['dots'][name]} times, "
                                 f"expected {n}")
    unequal = sum(not torch.equal(a, b) for a, b in zip(runs["none"], runs["dots"]))
    if unequal:
        raise AssertionError(f"remat block_sparse: {unequal} gradients differ between "
                             "'dots' and 'none'")
    stats["block_sparse grads equal"] = len(runs["none"])
    del runs
    masked = apply_masks(state["params"], state["masks"])
    del state
    torch.cuda.empty_cache()
    for attn in ("flash_tight", "dense"):
        runs, dots = {}, {}
        for policy, remat in (("off", False), ("none", True), ("dots", True)):
            c = remat_config("dense", attn, "none" if policy == "off" else policy, remat)
            loss_grads(torch, c, masked, batch)  # warm
            count = dot_counter(torch)
            zero_counters(mods)
            loss, grads, s, peak = loss_grads(torch, c, masked, batch, count=count)
            runs[policy], dots[policy] = grads, count.n
            stats[f"dense {attn} {policy}"] = {"loss": loss, "s": s, "peak_gib": peak,
                                               "backward_dots": count.n,
                                               "launches": read_counters(mods)}
        if not dots["none"] > dots["off"] > 0 or dots["dots"] != dots["off"]:
            raise AssertionError(f"remat dense {attn}: backward dense products {dots} "
                                 "(expected dots == off < none)")
        unequal = sum(not torch.equal(a, b) for a, b in zip(runs["none"], runs["dots"]))
        if unequal:
            raise AssertionError(f"remat dense {attn}: {unequal} gradients differ between "
                                 "'dots' and 'none'")
        stats[f"dense {attn} grads equal"] = len(runs["none"])
        del runs
        torch.cuda.empty_cache()
    for k, v in stats.items():
        print(f"remat: {k}: {json.dumps(v)}")
    return stats, launches["dots"]


def dp_config(microbatches):
    """The train phase's danube (block_sparse 128 x 128, flash_tight, ERK
    0.8, RigL with the Top-KAST superset, delta_t 2) at full width, 4 of
    24 layers, in ``microbatches`` of 2 x 1024 rows a step."""
    return dataclasses.replace(train_config(), n_layers=DP_LAYERS, microbatches=microbatches)


def state_digests(torch, state):
    """sha256 of the masks, the supersets and the pack, each over its
    leaves in path order, on host copies."""
    import hashlib

    from repro_torch.core.masks import tree_paths
    from repro_torch.core.pack import pack_entries

    def digest(items):
        h = hashlib.sha256()
        for name, t in items:
            h.update(name.encode())
            h.update(t.cpu().numpy().tobytes() if torch.is_tensor(t) else repr(t).encode())
        return h.hexdigest()

    pack = [(f"{n}/{k}", e[k]) for n, e in pack_entries(state["pack"]) for k in sorted(e)]
    return {"masks": digest(sorted(tree_paths(state["masks"]).items())),
            "bwd_masks": digest(sorted(tree_paths(state["bwd_masks"]).items())),
            "pack": digest(pack)}


def dp_run(torch, cfg, mods, workdir, mesh=None):
    """``train_loop`` for DP_STEPS steps of DP_BATCH x 1024 (each rank's
    rows under ``mesh``) -> (per-step records, final state, launches)."""
    from repro_torch.launch.train import train_loop

    log, last = [], [None]

    def on_step(step, is_update, state, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec = {"step": step, "update": is_update, "loss": float(m["loss"]),
               "launches": read_counters(mods)}
        if last[0] is not None:
            rec["wall_s"] = now - last[0]
        log.append(rec)
        torch.cuda.synchronize()
        last[0] = time.perf_counter()

    zero_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    last[0] = time.perf_counter()
    state, _ = train_loop(cfg, steps=DP_STEPS, batch=DP_BATCH, seq=TRAIN_SEQ,
                          workdir=str(workdir), device="cuda", on_step=on_step,
                          log_every=DP_STEPS, ckpt_every=None, mesh=mesh)
    torch.cuda.synchronize()
    return log, state, read_counters(mods)


def dp_rank(rank, world, port, out):
    """One data-parallel rank (a spawned process): gloo over 127.0.0.1,
    ``make_local_mesh(world, 1)`` on the one card, ``train_loop`` on this
    rank's rows; writes its losses, per-step launches and seconds, the
    all-reduce's seconds, peak GiB and the state's digests to ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.kernels import block_sparse_matmul as bsm
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.training import steps as ts

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_local_mesh(world, 1, device_type="cuda")
        reduce_s, real = [], ts._all_reduce_mean

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(*a, **kw)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)

        ts._all_reduce_mean = timed
        log, state, launches = dp_run(torch, dp_config(DP_BATCH // 2 // world), {
            "bsm": bsm, "fa": fa}, ROOT / "chiprun_out" / "dp_train", mesh=mesh)
        report = {"rank": rank, "log": log, "launches": launches, "allreduce_s": reduce_s,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "digests": state_digests(torch, state)}
        Path(out).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_one_rank(torch):
    """One rank under NCCL (the backend a multi-card mesh runs) through the
    data-parallel train step, against the plain step on the same state and
    batch: every leaf of the state and the loss equal bit for bit."""
    import torch.distributed as dist
    from repro_torch.data.synthetic import batch_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.sharding import shard_batch
    from repro_torch.optim.lr import LRSchedule
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state, make_train_step

    cfg = dp_config(1)
    opt = OptConfig(kind="adam", weight_decay=0.0, grad_clip=1.0)
    lr = LRSchedule(kind="constant", base_lr=3e-3, warmup_steps=0)
    batch = batch_for(cfg, 0, 2, TRAIN_SEQ, learnable=True, device="cuda")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        out = {}
        for name, m in (("plain", None), ("nccl", mesh)):
            state, _ = init_train_state(cfg, opt, seed=0, device="cuda")
            b = batch if m is None else shard_batch(batch, m)
            state, metrics = make_train_step(cfg, opt, lr, mesh=m)(state, b)
            torch.cuda.synchronize()
            out[name] = (state, float(metrics["loss"]))
            if name == "plain":  # one state on the card at a time beside the next
                host = tree_map_to(torch, state, "cpu")
                del state
                out[name] = (host, out[name][1])
                torch.cuda.empty_cache()
        bad = same_state(torch, out["plain"][0], tree_map_to(torch, out["nccl"][0], "cpu"))
    finally:
        dist.destroy_process_group()
    if bad or out["plain"][1] != out["nccl"][1]:
        raise AssertionError(f"dp: the one-rank NCCL step differs from the plain step: "
                             f"{len(bad)} leaves {bad[:8]}, losses {out['plain'][1]} vs "
                             f"{out['nccl'][1]}")
    n = []
    from repro_torch.core.masks import tree_map

    tree_map(lambda *_: n.append(1), out["plain"][0])
    return {"leaves_equal": len(n), "loss": out["plain"][1]}


def tree_map_to(torch, tree, device):
    """Every tensor of a state tree moved to ``device``; other leaves as
    they are."""
    from repro_torch.core.masks import tree_map

    return tree_map(lambda _, t: t.to(device) if torch.is_tensor(t) else t, tree)


def dp_phase(torch, bsm, fa):
    """Data parallelism on one card: a single-process ``train_loop`` (4
    microbatches of 2 x 1024 rows a step), then two spawned gloo ranks
    (``make_local_mesh(2, 1)``, 2 microbatches of 2 x 1024 each) through
    the same 4 steps from the same seed (two train steps, a drop/grow,
    a train step): losses within the reference's rel 2e-3 of the single
    process's, masks, supersets and packs identical across the ranks
    (digests), each rank's K1-K3 and K9-K11 a train step half the single
    process's (the update step's one pass each); each step's seconds, the
    all-reduce's and peak GiB a rank.  Then one rank under NCCL through
    the same step, bit for bit the plain step."""
    import multiprocessing

    mods = {"bsm": bsm, "fa": fa}
    single, state, single_launches = dp_run(torch, dp_config(DP_BATCH // 2), mods,
                                            ROOT / "chiprun_out" / "dp_single")
    single_digests = state_digests(torch, state)
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    port, world = free_port(), 2
    outs = [ROOT / "chiprun_out" / f"dp_rank{r}.json" for r in range(world)]
    for o in outs:
        o.unlink(missing_ok=True)
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dp_rank, args=(r, world, port, str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"dp: rank exit codes {codes}")
    reports = [json.loads(o.read_text()) for o in outs]

    losses = [[r["loss"] for r in rep["log"]] for rep in reports]
    want = [r["loss"] for r in single]
    if any(lo != losses[0] for lo in losses):
        raise AssertionError(f"dp: the ranks' losses differ: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[0], want)]
    if not max(rel) <= 2e-3:
        raise AssertionError(f"dp: losses {losses[0]} vs one process {want} (rel {rel})")
    digests = [rep["digests"] for rep in reports]
    if any(d != digests[0] for d in digests):
        raise AssertionError(f"dp: masks, supersets or packs differ across ranks: {digests}")
    updates = [r["update"] for r in single]
    if updates != [False, False, True, False]:
        raise AssertionError(f"dp: updates {updates}")

    def per_step(log):
        prev, out = dict.fromkeys(DP_KERNELS, 0), []
        for r in log:
            out.append({k: r["launches"][k] - prev[k] for k in DP_KERNELS})
            prev = r["launches"]
        return out

    one = per_step(single)
    for rep in reports:
        for i, (mine, theirs) in enumerate(zip(per_step(rep["log"]), one)):
            expect = theirs if updates[i] else {k: v // 2 for k, v in theirs.items()}
            if mine != expect or 0 in mine.values():
                raise AssertionError(f"dp rank {rep['rank']} step {i + 1}: launches {mine}, "
                                     f"expected {expect}")
    nccl = nccl_one_rank(torch)
    wall = lambda log: [r.get("wall_s") for r in log]
    stats = {"layers": DP_LAYERS, "global_batch": [DP_BATCH, TRAIN_SEQ],
             "single": {"losses": want, "step_wall_s": wall(single), "peak_gib": single_peak,
                        "digests": single_digests,
                        "digests_equal_ranks": single_digests == digests[0]},
             "ranks": [{"losses": losses[i], "step_wall_s": wall(rep["log"]),
                        "allreduce_s": rep["allreduce_s"], "peak_gib": rep["peak_gib"],
                        "launches_per_step": per_step(rep["log"])}
                       for i, rep in enumerate(reports)],
             "loss_rel_err": rel, "ranks_wall_s": ranks_s, "nccl_one_rank": nccl}
    print(f"dp: one process {want}; ranks {losses[0]} (rel {max(rel):.2e}); step s one "
          f"process {wall(single)}, rank 0 {wall(reports[0]['log'])}; all-reduce s rank 0 "
          f"{reports[0]['allreduce_s']}; peak GiB one process {single_peak:.1f}, ranks "
          f"{[round(r['peak_gib'], 1) for r in reports]}; digests equal across ranks, "
          f"{'equal' if stats['single']['digests_equal_ranks'] else 'not equal'} to the one "
          f"process's; NCCL one rank {nccl}")
    return stats, reports[0]["launches"], single_launches


def tree_map_clone(tree):
    from repro_torch.core.masks import tree_map

    return tree_map(lambda _, t: None if t is None else t.clone(), tree)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.attn_sched import sched_for
    from repro_torch.core.pack import pack_np
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sparse_matmul as bsm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_matmul as mm

    t_start = time.perf_counter()
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, per kernel "
          f"{ {k: round(v, 1) for k, v in secs.items()} }")
    for name in _build.KERNELS:
        log = _build.lib_path(name).with_suffix(".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln]
        print(f"build: {name}: {'; '.join(usage)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    timer = Timer(torch)
    phase_s = {}
    mark = [time.perf_counter()]

    def done(phase):
        now = time.perf_counter()
        phase_s[phase] = round(now - mark[0], 1)
        mark[0] = now
        torch.cuda.empty_cache()

    k1 = k1_cases(torch, timer, bsm, pack_np)
    k9 = k9_cases(torch, timer, fa, sched_for)
    done("parity K1, K9")

    serve_stats, serve_launches, k1_served = main_path(torch, timer, bsm, fa)
    k1 += k1_served
    done("serve")

    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.training.steps import init_train_state

    cfg = train_config()
    # the run's own initial weights, masks, supersets and packs (seed 0;
    # the draws do not depend on the optimizer, so sgd keeps this copy small)
    state, _ = init_train_state(cfg, OptConfig(kind="sgd"), seed=0, device="cuda")
    k2, k3, k3_merges, k2_merges = bs_bwd_cases(torch, timer, bsm, pack_np, state, cfg)
    k10, k11 = flash_bwd_cases(torch, timer, fa)
    done("parity K2, K3, K10, K11")
    dense_check = train_dense_check(torch, cfg, state)
    merges0 = {e: tuple(bs_merges(torch, cfg, state, n, e) for n in (
        TRAIN_BATCH * TRAIN_SEQ // cfg.microbatches, TRAIN_BATCH * TRAIN_SEQ))
        for e in BS_ENTRIES}
    del state
    done("train step-0 check")
    train_stats, train_launches = train_path(torch, bsm, fa, mm, cfg, merges0)
    train_stats["step0_vs_dense"] = dense_check
    done("train")

    masked_serve_stats, masked_serve_launches, mcases = masked_serve(torch, timer, mm, fa)
    done("masked serve, parity K13, K14, K15, K19")
    masked_train_stats, masked_train_launches = masked_train(torch, mm, fa, bsm)
    done("masked train")
    fused_stats, fused_launches = fused_train(torch, mm)
    done("fused train")
    fused_bs_stats, fused_bs_launches, k7, k7_merges = fused_bs_train(torch, timer, bsm, fa)
    done("fused block-sparse train, parity K7")
    k12 = k12_cases(torch, timer, fa)
    done("parity K12")
    paged_stats, paged_launches, k1_paged = paged_serve(torch, timer, bsm, fa)
    k1 += k1_paged
    done("paged serve")
    moe_stats, moe_launches, k4 = moe_serve(torch, timer, bsm, mm, fa, "block_sparse")
    done("moe serve, parity K4")
    moe_m_stats, moe_m_launches, k16 = moe_serve(torch, timer, bsm, mm, fa, "masked")
    done("moe masked serve, parity K16")
    k10_g1, k11_g1 = flash_bwd_cases(torch, timer, fa, G=1, d=128, cases=(
        ("S=1024 causal (qwen2-moe train shape)", 16, 1024, 0, 0.0),))
    k10 += k10_g1
    k11 += k11_g1
    moe_train_stats, moe_train_launches, k56 = moe_train(torch, timer, bsm, mm, fa,
                                                         "block_sparse")
    done("moe train, parity K5, K6, K10/K11 at G = 1")
    moe_mtrain_stats, moe_mtrain_launches, k1718 = moe_train(torch, timer, bsm, mm, fa,
                                                             "masked")
    done("moe masked train, parity K17, K18")
    moe_fused_stats, moe_fused_launches, k8, k7_moe, k78_merges = moe_fused_train(
        torch, timer, bsm, mm, fa, "block_sparse")
    k7 += k7_moe
    k7_merges += k78_merges
    done("moe fused train, parity K8, K8 vs K20, K7")
    moe_mfused_stats, moe_mfused_launches, k20, k19_moe, k20_merges = moe_fused_train(
        torch, timer, bsm, mm, fa, "masked")
    mcases["K19"] += k19_moe
    mcases["dw_fused_merge"] += k20_merges
    done("moe masked fused train, parity K20, K19")
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_threshold as tk

    k21, topk_thr, topk_launches = topk_cases(torch, timer, tk, ops)
    done("topk: parity K21, topk_threshold")
    methods, methods_launches = {}, {}
    for method in ("set", "snfs", "topkast", "pruning", "snip"):
        methods[method], methods_launches[f"methods_{method}"] = method_train(
            torch, bsm, mm, fa, tk, method)
        done(f"methods train: {method}")
    resume_stats, resume_launches = resume_phase(torch, bsm, fa)
    done("resume")
    chaos_stats, chaos_launches, served = chaos_serve(
        torch, bsm, fa, serve_stats["generated"])
    done("chaos + obs serve")
    lockstep_stats, lockstep_launches = lockstep_phase(
        torch, bsm, fa, served, chaos_stats["stats_obs_off"]["tok_per_s"])
    del served
    done("lockstep")
    gru_stats = gru_phase(torch)
    done("gru char LM, teacher")
    xlstm = {}
    for kernel in ("block_sparse", "masked"):
        xlstm[f"serve {kernel}"] = xlstm_serve(torch, bsm, mm, kernel)
        done(f"xlstm serve {kernel}")
        xlstm[f"train {kernel}"] = xlstm_train(torch, timer, bsm, mm, kernel)
        done(f"xlstm train {kernel}, parity at the r bank's shapes")
    k9_h, k10_h, k11_h = hymba_flash_cases(torch, timer, fa)
    k9 += k9_h
    k10 += k10_h
    k11 += k11_h
    done("hymba flash: K9-K11 at d = 64")
    hymba = {}
    for kernel in ("block_sparse", "masked"):
        hymba[f"serve {kernel}"] = hymba_serve(torch, timer, bsm, mm, fa, kernel)
        done(f"hymba serve {kernel}, parity at 64 x 64")
        hymba[f"train {kernel}"] = hymba_train(torch, timer, bsm, mm, fa, kernel)
        done(f"hymba train {kernel}")
    k1 += hymba["serve block_sparse"][2]
    for key, cases in hymba["serve masked"][2].items():
        mcases[key] += cases
    k2_h, k3_h, k3_merges_h, k2_merges_h = hymba["train block_sparse"][2]
    k2 += k2_h
    k3 += k3_h
    k3_merges += k3_merges_h
    k2_merges += k2_merges_h
    k9_g, k10_g, k11_g = gemma_flash_cases(torch, timer, fa)
    k9 += k9_g
    k10 += k10_g
    k11 += k11_g
    done("flash d = 256: K9-K11 at gemma3's attention")
    gemma = gemma_serve(torch, timer, bsm, mm, fa)
    done("gemma3 serve block_sparse, masked")
    for kernel in ("block_sparse", "masked"):
        gemma[f"train {kernel}"] = gemma_train(torch, timer, bsm, mm, fa, kernel)
        done(f"gemma3 train {kernel}")
    cmdr = {"serve": paged_serve(torch, timer, bsm, fa, cfg=command_r_config(),
                                 label="command-r serve", of=64)}
    k1 += cmdr["serve"][2]
    done("command-r serve")
    cmdr["train"] = command_r_train(torch, timer, bsm, mm, fa)
    done("command-r train")
    front_flash = frontend_flash_cases(torch, timer, fa)
    for fl in front_flash.values():
        k9 += fl["k9"]
        k10 += fl["k10"]
        k11 += fl["k11"]
    done("flash frontends: K9-K11 bidirectional at d = 80, G = 7 at d = 64")
    hubert = {"encode": hubert_encode(torch, bsm, mm, fa)}
    done("hubert encode block_sparse, masked")
    for kernel in ("block_sparse", "masked"):
        hubert[f"train {kernel}"] = hubert_train(torch, timer, bsm, mm, fa, kernel)
        done(f"hubert train {kernel}")
    internvl = {}
    internvl["serve"], k1_ivl = internvl_serve(torch, timer, bsm, mm, fa)
    k1 += k1_ivl
    done("internvl serve block_sparse, masked, contiguous and paged")
    for kernel in ("block_sparse", "masked"):
        internvl[f"train {kernel}"] = internvl_train(torch, timer, bsm, mm, fa, kernel)
        done(f"internvl train {kernel}")
    grok = grok_phases(torch, timer, bsm, mm, fa, done)
    remat_stats, remat_launches = remat_phase(torch, bsm, fa)
    done("remat dots: danube 4 layers, block_sparse and dense")
    dp_stats, dp_launches, dp_single_launches = dp_phase(torch, bsm, fa)
    done("data parallel: one process, two gloo ranks, one NCCL rank")
    for cases, more in zip((k9, k10, k11), grok["flash"]):
        cases += more
    r_bs, r_m = xlstm["train block_sparse"][2], xlstm["train masked"][2]
    k4 += r_bs["fwd"]
    k56["K5"] += r_bs["dx"]
    k56["K6"] += r_bs["dw"]
    k16 += r_m["fwd"]
    k1718["K17"] += r_m["dx"]
    k1718["K18"] += r_m["dw"]
    gb = grok["banks"]
    k4 += gb["K4"]
    k56["K5"] += gb["K5"]
    k56["K6"] += gb["K6"]
    k16 += gb["K16"]
    k1718["K17"] += gb["K17"]
    k1718["K18"] += gb["K18"]

    paths = {"serve": serve_launches, "train": train_launches,
             "masked_serve": masked_serve_launches, "masked_train": masked_train_launches,
             "fused_train": fused_launches, "paged_serve": paged_launches,
             "moe_serve": moe_launches, "moe_masked_serve": moe_m_launches,
             "moe_train": moe_train_launches, "moe_masked_train": moe_mtrain_launches,
             "fused_block_sparse_train": fused_bs_launches,
             "moe_fused_train": moe_fused_launches,
             "moe_masked_fused_train": moe_mfused_launches, "topk": topk_launches,
             **methods_launches, "resume": resume_launches,
             "chaos_serve": chaos_launches, "lockstep": lockstep_launches,
             "xlstm_serve": xlstm["serve block_sparse"][1],
             "xlstm_masked_serve": xlstm["serve masked"][1],
             "xlstm_train": xlstm["train block_sparse"][1],
             "xlstm_masked_train": xlstm["train masked"][1],
             "hymba_serve": hymba["serve block_sparse"][1],
             "hymba_masked_serve": hymba["serve masked"][1],
             "hymba_train": hymba["train block_sparse"][1],
             "hymba_masked_train": hymba["train masked"][1],
             "gemma3_serve": gemma["block_sparse paged"][1],
             "gemma3_masked_serve": gemma["masked paged"][1],
             "gemma3_train": gemma["train block_sparse"][1],
             "gemma3_masked_train": gemma["train masked"][1],
             "command_r_serve": cmdr["serve"][1], "command_r_train": cmdr["train"][1],
             "hubert_encode": hubert["encode"]["block_sparse"][1],
             "hubert_masked_encode": hubert["encode"]["masked"][1],
             "hubert_train": hubert["train block_sparse"][1],
             "hubert_masked_train": hubert["train masked"][1],
             **{f"internvl_{k.replace(' ', '_')}_serve": v[1]
                for k, v in internvl["serve"].items() if k != "parameters"},
             "internvl_train": internvl["train block_sparse"][1],
             "internvl_masked_train": internvl["train masked"][1],
             "grok_serve": grok["serve"]["block_sparse"][1],
             "grok_masked_serve": grok["serve"]["masked"][1],
             "grok_train": grok["train block_sparse"][1],
             "grok_masked_train": grok["train masked"][1],
             "remat_dots": remat_launches, "dp_single_process": dp_single_launches,
             "dp_rank0": dp_launches}
    names = sorted({n for p in paths.values() for n in p})
    by_path = {n: {k: p.get(n, 0) for k, p in paths.items()} for n in names}
    launches = {n: sum(by_path[n].values()) for n in names}

    def summary(name, source, replaces, cases):
        # cases without a library yardstick (parity only) are not timed,
        # unless no case of the kernel has one (the fused epilogues K7, K8,
        # K19, K20: no one PyTorch call; K7, K8 and K20 report the unfused
        # work they replace as unfused_ms)
        timed = [c for c in cases if c["library_ms"] is not None] or cases
        total = lambda key: sum(c[key] for c in timed)
        b = sum(c["bound_ms"] for c in timed)
        by_bytes = sum(c["bound_ms"] for c in timed if c["bound_by"] == "bytes")
        out = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "launches_by_path": by_path[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": b,
            "bound_by": "bytes" if by_bytes >= b / 2 else "operations",
            "library_ms": total("library_ms") if timed[0]["library_ms"] is not None else None,
            "cases_timed": len(timed),
        }
        if all("unfused_ms" in c for c in timed):
            out["unfused_ms"] = total("unfused_ms")
        return out

    csrc, kern = "src/repro_torch/csrc/", "src/repro/kernels/"
    dx_merges = mcases["dx_merge"] + k1718["dx_merge"]
    dw_merges = mcases["dw_merge"] + k1718["dw_merge"]
    bs_dw_merge_cases = k3_merges + k56["merge"]
    bs_dx_merge_cases = k2_merges + k56["dx_merge"]
    bs_fwd_merge_cases = [c["merge_case"] for c in k1 + k4 if "merge_case" in c]
    report = {"kernels": [
        summary("block_sparse_fwd", csrc + "block_sparse_fwd.cu",
                kern + "block_sparse_matmul.py:223", k1),
        # K1's and K4's split merge (the masked forward's masked_merge_kernel,
        # counted on its own), where a timed case's plan splits
        *([summary("block_sparse_fwd_merge", csrc + "masked_matmul.cu",
                   kern + "block_sparse_matmul.py:223", bs_fwd_merge_cases)]
          if bs_fwd_merge_cases else []),
        summary("block_sparse_dx", csrc + "block_sparse_bwd.cu",
                kern + "block_sparse_matmul.py:243", k2),
        # K2's and K5's split merge (the masked forward's masked_merge_kernel,
        # counted on its own), where a timed case's plan splits
        *([summary("block_sparse_dx_merge", csrc + "masked_matmul.cu",
                   kern + "block_sparse_matmul.py:243", bs_dx_merge_cases)]
          if bs_dx_merge_cases else []),
        summary("block_sparse_dw", csrc + "block_sparse_bwd.cu",
                kern + "block_sparse_matmul.py:265", k3),
        # K3's and K6's split merge (block_sparse_dw_merge_kernel: the
        # packed partials summed in order into dw's live blocks), where a
        # timed case's plan splits
        *([summary("block_sparse_dw_merge", csrc + "block_sparse_bwd.cu",
                   kern + "block_sparse_matmul.py:265", bs_dw_merge_cases)]
          if bs_dw_merge_cases else []),
        summary("flash_fwd", csrc + "flash_fwd.cu", kern + "flash_attention.py:103", k9),
        summary("flash_dq", csrc + "flash_bwd.cu", kern + "flash_attention.py:161", k10),
        summary("flash_dkv", csrc + "flash_bwd.cu", kern + "flash_attention.py:207", k11),
        summary("masked_fwd", csrc + "masked_matmul.cu", kern + "masked_matmul.py:79",
                mcases["K13"]),
        summary("masked_fwd_merge", csrc + "masked_matmul.cu", kern + "masked_matmul.py:79",
                mcases["merge"]),
        summary("masked_dx", csrc + "masked_matmul.cu", kern + "masked_matmul.py:96",
                mcases["K14"]),
        # K14's and K17's split merge (the forward's merge kernel, counted
        # on its own), where a timed case's plan splits
        *([summary("masked_dx_merge", csrc + "masked_matmul.cu",
                   kern + "masked_matmul.py:96", dx_merges)] if dx_merges else []),
        summary("masked_dw", csrc + "masked_matmul.cu", kern + "masked_matmul.py:115",
                mcases["K15"]),
        # K15's and K18's split merge (masked_dw_merge_kernel: the ordered
        # sum times the mask), where a timed case's plan splits
        *([summary("masked_dw_merge", csrc + "masked_matmul.cu",
                   kern + "masked_matmul.py:115", dw_merges)] if dw_merges else []),
        summary("masked_dw_fused", csrc + "masked_matmul.cu", kern + "masked_matmul.py:498",
                mcases["K19"]),
        # K19's and K20's split merge (masked_merge_kernel with the momentum
        # epilogue), where a timed case's plan splits
        *([summary("masked_dw_fused_merge", csrc + "masked_matmul.cu",
                   kern + "masked_matmul.py:498", mcases["dw_fused_merge"])]
          if mcases["dw_fused_merge"] else []),
        summary("paged_flash_fwd", csrc + "flash_paged.cu", kern + "flash_attention.py:317",
                k12),
        summary("grouped_block_sparse_fwd", csrc + "block_sparse_grouped.cu",
                kern + "block_sparse_matmul.py:491", k4),
        summary("grouped_masked_fwd", csrc + "masked_matmul.cu",
                kern + "masked_matmul.py:239", k16),
        summary("grouped_block_sparse_dx", csrc + "block_sparse_grouped.cu",
                kern + "block_sparse_matmul.py:511", k56["K5"]),
        summary("grouped_block_sparse_dw", csrc + "block_sparse_grouped.cu",
                kern + "block_sparse_matmul.py:533", k56["K6"]),
        summary("grouped_masked_dx", csrc + "masked_matmul.cu",
                kern + "masked_matmul.py:254", k1718["K17"]),
        summary("grouped_masked_dw", csrc + "masked_matmul.cu",
                kern + "masked_matmul.py:272", k1718["K18"]),
        summary("block_sparse_dw_fused", csrc + "block_sparse_bwd.cu",
                kern + "block_sparse_matmul.py:900", k7),
        summary("grouped_block_sparse_dw_fused", csrc + "block_sparse_grouped.cu",
                kern + "block_sparse_matmul.py:1078", k8),
        # K7's and K8's split merge (block_sparse_dw_fused_merge_kernel: K3's
        # merge with the momentum epilogue), where a timed case's plan splits
        *([summary("block_sparse_dw_fused_merge", csrc + "block_sparse_bwd.cu",
                   kern + "block_sparse_matmul.py:900", k7_merges)] if k7_merges else []),
        summary("grouped_masked_dw_fused", csrc + "masked_matmul.cu",
                kern + "masked_matmul.py:616", k20),
        summary("histogram_abs", csrc + "topk_threshold.cu", kern + "topk_threshold.py:29",
                k21),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "phase_s": phase_s, "k1": k1, "k2": k2, "k3": k3,
         "bs_dw_merge": bs_dw_merge_cases, "bs_fwd_merge": bs_fwd_merge_cases,
         "bs_dx_merge": bs_dx_merge_cases, "k9": k9,
         "k10": k10, "k11": k11, "engine": serve_stats, "train": train_stats,
         "masked_cases": mcases, "masked_engine": masked_serve_stats,
         "masked_train": masked_train_stats, "fused_train": fused_stats,
         "k12": k12, "paged_engine": paged_stats, "k4": k4, "k16": k16,
         "moe_engine": moe_stats, "moe_masked_engine": moe_m_stats,
         "k10_g1": k10_g1, "k11_g1": k11_g1, "k5_k6": k56, "k17_k18": k1718,
         "moe_train": moe_train_stats, "moe_masked_train": moe_mtrain_stats,
         "fused_block_sparse_train": fused_bs_stats, "k7": k7, "k8": k8,
         "bs_dw_fused_merge": k7_merges, "k20": k20,
         "moe_fused_train": moe_fused_stats, "moe_masked_fused_train": moe_mfused_stats,
         "k21": k21, "topk_threshold": topk_thr, "methods": methods,
         "resume": resume_stats, "chaos_serve": chaos_stats, "lockstep": lockstep_stats,
         "gru": gru_stats, "xlstm": {k: v[0] for k, v in xlstm.items()},
         "r_bank": {"block_sparse": r_bs, "masked": r_m},
         "hymba": {k: v[0] for k, v in hymba.items()},
         "hymba_flash": {"k9": k9_h, "k10": k10_h, "k11": k11_h},
         "gemma3_flash": {"k9": k9_g, "k10": k10_g, "k11": k11_g},
         "gemma3": {k: v[0] for k, v in gemma.items() if k != "parameters"},
         "command_r": {k: v[0] for k, v in cmdr.items()},
         "frontend_flash": front_flash,
         "hubert": {"encode": {k: v[0] if k in ("block_sparse", "masked") else v
                               for k, v in hubert["encode"].items()},
                    **{k: v[0] for k, v in hubert.items() if k != "encode"}},
         "internvl": {"serve": {k: v[0] if k != "parameters" else v
                                for k, v in internvl["serve"].items()},
                      **{k: v[0] for k, v in internvl.items() if k != "serve"}},
         "grok": {"flash": dict(zip(("k9", "k10", "k11"), grok["flash"])),
                  "banks": grok["banks"],
                  "serve": {k: v[0] if k in ("block_sparse", "masked") else v
                            for k, v in grok["serve"].items()},
                  **{k: v[0] for k, v in grok.items() if k.startswith("train")}},
         "remat": remat_stats, "data_parallel": dp_stats,
         "launches": by_path, "report": report}, indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s; phases {phase_s}")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
