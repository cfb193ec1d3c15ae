#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero at the first
failure and prints no result):

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — every CUDA kernel from src/repro_torch/kernels/csrc, and the
                count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in
                the SASS (cuobjdump) of each of the three Hopper flash kernels
                (the forward, dQ and dK/dV), and of HMMA (mma.sync) and LDGSTS
                (cp.async) in the backward pair of f32 and hd 16, none of
                which may be 0;
  3. parity   — each kernel against its plain PyTorch version on the card,
                at the main path's shapes (capacity 50,000, K=128, B=64),
                at the Nature-DQN replay size (1,000,000, K=128, B=512),
                at the token-DQN training path's replay (8,192, K=128, B=8,
                rows of 256 int32 tokens and actions and f32 rewards and
                dones), at K=8 and K=256 (100,000) and on a tree whose root is
                bumped above its children (the padded-tail clamp), under
                the rules of src/repro_torch/kernels/parity.py: sampled
                indices under the fp-tie rule (at B and at 65,536 draws),
                rows bit-exact (one leaf a launch, every leaf in one
                gather_items launch, the fused kernel; and rows holding inf,
                NaN and int32 above 2^24 through all three, byte for byte),
                the update's leaves bit for bit and each interior level at
                rtol 1e-5 plus 1e-6 of its magnitude, and a second call bit
                for bit the same; then, at 50,000/K=128, the update at B = 1,
                8, 64, 512, 1,025 and 2,100 with repeats spread across the
                batch and its chunks of 1,024 (ceil(B / 1,024) launches, a
                second call bit for bit), and the fused kernel on a table of
                1-, 4-, 12-, 16- and 1,024-byte rows with views 4, 2 and 1
                bytes off alignment and on 16 leaves (indices and
                priorities those of the split descent, rows byte for byte);
  4. main path — FusedExecutor on CUDA with the settings of
                tests/test_system.py (CartPole × 8 envs, DQN (4, 256, 256, 2),
                capacity 20,000, K=128, batch 64, 1,400 iterations): the
                return must beat 30, the sample and gather kernels must
                have launched, one gather launch for each descent (every
                storage leaf in one launch), and a step must not synchronize
                with the host (checked under torch.cuda.set_sync_debug_mode);
  5. arms     — 100 iterations each of the fused sample+gather arm and the
                eager-replay arm, which launch the other two kernels: one
                fused launch a learner call, one update launch a learner
                call and two an iteration (the insert's two phases), each
                count equal to the tree op's calls;
  6. times    — the launch floor (torch.cuda._sleep(0)); each kernel, its
                plain version and the library call (searchsorted on the
                leaves' CDF for the descent, index_select for the gather):
                device time, the median of 30 calls queued back to back
                behind a GPU sleep, one CUDA-event pair each (the update
                kernel, and beside it ops.sumtree_update, the replay's call:
                wrapper_ms); gather_items over every leaf;
                the call latency from an idle card, Python wrapper included;
                and a learner call's sampling chain in four arms, in turns
                (sampling_chain), at 50,000/B=64 with CartPole's five leaves
                and at 8,192/B=8 with the token replay's four;
  7. flash    — the flash-attention forward kernels against their plain
                version: the five mask cases of tests/test_flash_attention.py
                at (4, 256, 64) f32, (8, 128, 16) f32, a ragged S = 200 at
                hd 128/96/64 (the f32 kernel); the Granite-8B prefill shapes
                (32, 512, 128) and (32, 128, 128), (32, 4096, 128), the
                training shape (128, 256, 128), hd 96 at a ragged S and the
                sliding and chunked masks at hd 128 in bf16 (the Hopper
                kernel), under parity.flash_check;
  8. serve    — the token-model serve path: Granite-8B at its published
                width and depth (36 layers, bf16, random weights from the
                seed) with attn_impl="flash" through ActorServer (8 slots,
                buckets 128/256/512, max_len 544), 8 requests of 1-512
                prompt tokens and 32 new tokens each: exact token accounting,
                prefill shapes <= 3, and the Hopper forward's launches equal
                to the count the code predicts (attention layers x prefills x
                one pass), none of the f32 kernel.  The same prompts with
                attn_impl="naive", and the prefill logits of both against the
                same weights in f32
                (naive attention): flash no farther from the f32 model than
                1.1x naive's distance, flash vs naive within 3e-2 relative
                l2, first-token agreement.  Then a torch.profiler window
                over one prefill and 8 decode steps;
  9. solo     — continuous batching against solo greedy decodes at
                granite_8b SMOKE in f32 (TF32 off): a token may differ only
                where the solo logits' top-2 margin is below 1e-5;
 10. flash times — the Hopper forward, its plain version and SDPA (the
                library yardstick) at (32, 512, 128), (32, 4096, 128) and
                (128, 256, 128) bf16 causal; the f32 kernel at (4, 256, 64) f32
                causal.

 11. flash bwd — the backward pair that _bwd_kernel_for picks (the Hopper dQ
                and dK/dV kernels for bf16 at hd 64/96/128, the mma.sync
                pair for f32 and hd 16) against the plain backward (in f32 on
                the same q, k, v, dO and the forward kernel's O and LSE), on
                all of phase 7's cases (the serve and train shapes, (32, 4096,
                128), hd 96 at S = 1000, sliding and chunked at hd 128) and the
                wall-clock trainer's (32, 128, 16) in f32 and in bf16, under
                parity.flash_bwd_check, one launch of each kernel of the pair
                and none of the other, and a second call bit for bit the same;
                and the FlashAttention Function's gradients against autograd
                through the plain forward, three masks at (3, 200, 64) f32;
 12. grad gate — InternLM2-1.8B at its published width and depth in bf16
                with remat (each unit checkpointed), one TD loss and its
                gradients on each of four seeded (8, 256) batches with flash
                and with naive attention, against the same weights in f32
                (naive, TF32 off): flash's gradients, per-position Q(s, a) and
                TD no farther from the f32 model than 1.1x naive's (the loss
                and the per-sequence |TD| reported beside them); 72 Hopper
                forward launches (online, target, the recompute) and 24 of
                each Hopper backward kernel; on the first batch the loss and
                gradients with remat off too, reported against remat on (bit
                for bit, or the largest difference) and held to the same gate;
 13. train    — `python -m repro_torch.launch.train`'s main at InternLM2-1.8B's
                full width and depth with remat, flash, --seq 128 --batch 8
                --n-envs 16 --steps 2 --ckpt-every 1: 72 Hopper forward, 24
                Hopper dQ and 24 Hopper dK/dV launches per train step (none of
                the f32 forward and backward kernels) and the sample and
                gather kernels on every step,
                finite losses, moved parameters, the tree's root changed at the
                flush after update_priorities, the sample and gather kernels
                against their plain versions on the run's own tree and token
                rows, a profiled train step, a second call with --steps 3
                --ckpt-every 0 that resumes from step 2, the step-2
                checkpoint restored into that call's fresh state bit for bit
                (every tensor's 128-bit fingerprint: ``fingerprints``), its
                final save observed and not written (nothing reads it), and
                the peak memory of both calls;
     13(b)    — bf16 Adam moments (AdamConfig(lr=1e-4, state_dtype="bfloat16"))
                on a fresh InternLM2-1.8B state, two train steps on seeded
                (8, 256) batches: every moment bf16, the second update of the
                embedding, unit 0's wq and the final norm's scale bit for bit
                the reference's formula in plain f32 torch ops on the card
                from its saved inputs, and a step's peak memory, and its rise
                above the resident state, against the same step with f32
                moments, with remat and without;
 14. bwd times — the Hopper dQ and dK/dV kernels at (128, 256, 128) and
                (32, 4096, 128) bf16 causal beside their bounds, their plain
                versions and one SDPA backward call that computes all three
                gradients, with the TFLOP/s reached on the work the bounds
                count (3 and 4 products a pair) and on the products the
                kernels do (the hi/lo splits: 4 and 7); the mma.sync pair
                (#6b, #7b) the same way at (128, 256, 128) f32 causal, its
                bound at the 3xTF32 rate (165 TFLOP/s) and at the FMA rate
                (67) beside it, and in bf16 at (128, 256, 128);
 15. restart  — tests/test_system.py's checkpoint restart on the card:
                CartPole x 4, DQN, capacity 1,024 K=8, batch 32, 30
                iterations; the agent's state saved, clobbered with NaN and
                restored bit for bit (parameters, target, Adam count and
                moments, step), and one more step with a finite loss;
 16. async    — AsyncExecutor on CartPole with the settings of
                tests/test_async_executor.py: (a) publish interval 1 against
                FusedExecutor over 40 iterations from one seed, every metric
                and every state tensor bit for bit; (b) publish interval 4
                over 12 iterations, the ages [1, 2, 3, 0] x 3 and the acting
                copy byte-identical between publishes; (c) publish interval
                4 for 256 iterations at the main path's settings: return
                above 30, one descent and one gather launch per learner
                call, no host sync in a step;
 17. actor-critic — DDPG, TD3 and SAC on Pendulum x 8 at the settings of
                benchmarks/fig10_scalability.py (hidden (256, 256), capacity
                50,000 K=128, batch 64, warmup 64, epsilon 0.1), 300
                iterations each, the three at once, each in a process of its
                own on this card: finite losses and priorities, actions in
                [-2, 2], one descent and one gather launch per learner call,
                no host sync in a step; then the descent, the gathers and
                the fused kernel against their plain versions on the run's
                own tree and 12/4/4/12/4-byte rows; one learn step on the
                card against the same step on the CPU from the same state,
                batch and noise (rtol 1e-4, atol 1e-5 on the loss, |TD| and
                every parameter and target tensor); the mean return and
                iterations per second (not gated); then the sampling chain on
                Pendulum's five leaves.

 18. sharded — the sharded runtime, each shard a rank of torch.distributed
                on this card (launch/mesh.py::spawn; the kernels built first):
                (a) one rank over NCCL, the settings of tests/test_executors.py
                (4 envs, capacity 1,024 K=8, batch 32, warmup 8, epsilon 0.2):
                ShardedExecutor on data_mesh(1) and on pod_data_mesh(1, 1)
                against FusedExecutor, 40 iterations, every metric and state
                tensor bit for bit, and no host sync in a step; (b) two ranks
                over gloo: gloo's all_reduce and broadcast on CUDA tensors,
                pod_data_mesh(2, 1) = data_mesh(2) bit for bit over 40
                iterations, then phase 4's settings split over 2 shards (4 envs,
                capacity 10,000 and batch 32 a shard, K=128), 256 iterations:
                return above 30, one descent and one gather launch per learner
                call on each rank, parameters, target, Adam state and step
                byte-identical on both ranks, #1 and #2 against their plain
                versions on each shard's tree and rows, iterations/s and a
                profiler window on rank 0 (no no-sync gate: gloo stages every
                collective through the host); (c) four ranks over gloo as 2x2
                pod x data, the int8-EF cross-pod reduce with bf16 inside a
                pod, then AsyncExecutor at publish interval 3 and max staleness
                1, 192 iterations each (384 until PR 20): finite losses, compress_error_norm > 0
                once learning starts, the EF buffer's norm moving between
                chunks, the state byte-identical on the 4 ranks, staggered ages;
                (d) world 2's learner state restored at world 1 and world 1's
                at world 2 (checkpoint/elastic.py): bit for bit on every rank,
                and a learning step with a finite loss after the replay refills.
 19. service — the replay service (src/repro_torch/service) through
                launch/multiprocess.py::launch_service, each role a process on
                this card meeting over localhost TCP: (a) 1 server + 2 actors
                (8 envs, chunks of 8) + 1 learner at the main path's width (DQN
                (4, 256, 256, 2), replay 20,000 x K=128, batch 64, spi 8, warmup
                400), 1,400 learn steps: every role on the card, the rate
                limiter inside its band (|samples - spi (inserts - min)| <=
                error buffer), eval return above 30, the server's launches one
                descent (#1) and one gather (#2) a sample and no other kernel,
                the wall per learn step; (b) 2 shards (10,000 each, round
                robin) sampled by the fused sample+gather (#3), the learner
                exiting at 200 learn steps and a fresh one resuming from its
                checkpoint to 400: two #3 launches a sample and no #1 or #2,
                RESUMED_FROM 200, the band; (c) in process: ServiceExecutor (1
                shard, RateLimiter.from_schedule) against FusedExecutor for 200
                iterations at the main path's settings, every state tensor,
                metric, the tree and the storage bit for bit, one #1 and one #2
                launch a learner call; and an ActorServer at granite_8b SMOKE
                (f32) whose param_source is a ReplayService on the card, swapping
                to a version put mid-run.
 20. dse      — the paper's design-space exploration and the wall-clock gang
                (runtime/dse.py, runtime/planner.py, executor_from_plan,
                launch/multiprocess.py's gang): (a) the lane curves of
                benchmarks/fig12_dse.py on the card (10 act+env steps of 1, 2,
                4, 8 CartPole envs; 10 DQN learn calls at batch 32 x lanes),
                Eq. 5 at a budget of 8 lanes and update interval 1 and 4, the
                planner's plan from those curves built by executor_from_plan on
                the card at the main path's width (DQN (4, 256, 256, 2), replay
                20,000 x K=128, batch 64, warmup 64) and run 100 iterations:
                one descent and one gather launch a learner call, no host sync
                in a step, the realized env-steps/s beside the predicted; then
                (b), (d) and (e) with their processes started together, and (c)
                alone: (b) --mode fused, one process through the tcp:// handshake, against
                FusedExecutor in this process, 30 iterations: loss, return, env
                steps and the parameter checksum bit for bit; (c) --mode bench,
                2 ranks over gloo on the card as a data mesh of 2, plain and
                with the host publish every 3 iterations: STEPS_PER_S and
                REL_SPREAD (recorded, not gated), one descent and one gather
                launch a learner call on each rank; (d) --mode equiv, 2
                processes: shift error 0.0 and telescoping error < 1e-6; (e)
                launch.train --arch granite_8b --smoke --attn-impl flash --seq
                128 --wall-clock 2, 3 steps: both workers' parameters equal
                after the last average, the f32 flash kernels (#5b, #6b, #7b)
                launched as the code predicts on each worker (with remat,
                three forwards a step), none of the Hopper ones; then those
                three kernels' times at the trainer's shape (32, 128, 16) f32
                causal beside their plain versions, SDPA and their bounds.
 21. big dense — Qwen1.5-32B and Command-R-35B, one at a time on a card that
                holds nothing else: (a) at full width and 4 layers, bf16 flash
                prefill logits against naive bf16 and both against the same
                weights in f32 on 4 prompts of 1-512 tokens, phase 8's gates;
                (b) at full width and depth in bf16 with flash through
                ActorServer (8 slots, buckets 128/256/512, max_len 544), 8
                requests of 1-512 prompt tokens and 16 new tokens: every
                request complete, every prompt's prefill logits and a decode
                step finite, the Hopper forward once a prefill per attention
                layer (64 and 40) and no other flash kernel, flash against
                naive prefill logits on 2 prompts under 3e-2 relative l2, the
                rates, the peak memory and one profiled decode step of the 8
                slots; (c) the Hopper forward at the prefill shape (heads,
                512, 128) bf16 causal beside its bound and SDPA;
 22. token-DQN — `python -m repro_torch.train_token_dqn`'s main at its
                39.9 M-parameter config (f32, naive attention), --steps 8
                --update-interval 64 --ckpt-every 4 --backend cuda: the
                printed schedule (every 2 collects, 1 update), 4 learn events
                with finite losses, the sample and gather kernels once a learn
                call and the update kernel twice an insert and once a priority
                write-back; the sample and gather kernels against their plain
                versions on the run's tree and rows (8 and 65,536 draws), the
                eagerly written tree against the plain rebuild of its leaves,
                and the update kernel against the plain update on one more
                32-row insert and 8-row write-back from that tree; then a
                second call that resumes from step 16.
 23. moe, vlm — one model at a time on a card that holds nothing else:
                (a) Mixtral-8x7B at full width and 24 of 32 layers, (b)
                Llama-4 Maverick at full width and 2 of 24 units (layers 0-3,
                global layer 3), each served as 21(b) (launches 24 and 4 a
                prefill, peak <= 74 GiB; the naive prefill routed as the flash
                one, moe.routed_as), with the tokens the prefills dropped;
                Mixtral's exactness check at 2 layers on one prompt of 4,608
                tokens, past its 4,096 window: the tokens bf16 flash and
                naive route apart from f32 (at most 10 %), and, routed as the
                f32 model, phase 21's rule; (d) Llama-4 with 16 slots, 12 on
                one prompt: the batched decode step against each slot's
                batch-1 call, the same experts and logits under 1e-2
                relative l2, no token dropped where a capacity over the slots
                would drop; (c) Phi-3-vision at full width and depth: 4
                prompts of 576 patch embeddings + 64 tokens prefilled at S =
                640 (32 launches), 16 greedy decode steps (pos 656 on every
                row), flash and naive bf16 against the f32 model (phase 21's
                rule); then the Hopper forward, held to its plain version,
                at (32, 4608, 128) sliding 4,096, (40, 512, 128) chunked 8,192
                local and global, and (32, 640, 96), beside its bound and
                SDPA with the same mask.
 24. hybrid, ssm — one model at a time on a card that holds nothing else:
                (a) Hymba-1.5B at full width and depth, bf16 with flash: 4
                prompts of 2,048 tokens (past its 1,024 window, 16 SSM chunks)
                prefilled (32 launches a prefill, no other flash kernel), 16
                greedy decode steps (pos 2,064); each decode step's logits
                against one forward over the prompt and the tokens fed (padded
                to 2,176 past them): relative l2 under 1e-3 with the same
                weights in f32 (fed the bf16 run's tokens), and in bf16 no
                farther from the f32 forward than 1.5x the bf16 forward; the
                prefill logits flash no farther from the f32 model than 1.1x
                naive bf16 (phase 21's rule; flash vs naive reported, since
                this family's bf16 arm lies ~6 % from f32, as the
                reference's does); the first greedy token against f32's, the
                peak memory, prefill and decode tokens/s;
                (b) `python -m repro_torch.launch.train --arch hymba_1_5b
                --attn-impl flash` at full width and depth, 1 step of 16
                actors x 128 tokens, replay 8,192 x K=128, batch 8, remat: a
                finite loss, grad norm and Q mean at every step (the
                reference's gradient is NaN here: ROADMAP Queue 3 item 13),
                one #1 and one #2 launch a step, 96 #5 and 32 each of #6 and
                #7 a step, none of the f32 kernels; (c) xLSTM-125M trained so
                at 64-token segments (#1 and #2 only) and served as (a) at 4
                prompts of 256 tokens, its bf16 prefill logits within 0.25
                relative l2 of the f32 model (no flash arm); (d) #5 held to
                its plain version and timed at Hymba's prefill (100, 2048, 64)
                local and global and its training shape (200, 128, 64), and
                #6 and #7 there, beside their bounds, plain times and SDPA.
 25. audio    — one model at a time on a card that holds nothing else:
                (a) Whisper-medium at full width and depth (24 + 24 layers, d
                1,024, 960,865,280 params), bf16 with flash: 4 prompts of 128
                tokens, each behind 1,500 frames drawn from the seed,
                prefilled (the encoder and the decoder once; 24 #5 launches
                a prefill, the decoder's: 1,500 frames and the
                cross-attention take the naive path) and 16 greedy decode
                steps, held as 24(a) (f32 decode against forward under 1e-3,
                the bf16 decode no farther from the f32 forward than 1.5x the
                bf16 forward, fed the bf16 run's tokens; flash no farther
                from the f32 model than 1.1x naive); prefill tokens/s and
                frames/s, decode tokens/s, the peak memory;
                (b) 2 steps of agents.token_dqn.train_step at full width and
                depth, 8 rows x 128 tokens behind their frames, remat, flash:
                finite losses and grad norms, every parameter tensor moved,
                72 #5, 24 #6 and 24 #7 launches a step and no f32 kernel; (c)
                #5, #6 and #7 at the encoder's width (64, 1536, 64)
                non-causal, a ragged (3, 1000, 64) non-causal and the
                decoder's (128, 128, 64) causal, held to their plain
                versions, beside their bounds, plain times and SDPA (phases
                7 and 11 hold the three cases too).
 26. sharding — launch/sharded.py, the token-DQN train step on a mesh of
                ranks with its state and batch as DTensors: (a) InternLM2-1.8B
                at full width and depth (bf16, flash, remat) on a 1x1 mesh of
                one NCCL rank in this process, one step bit for bit the
                unsharded step's (loss, grad norm, |TD|, every updated
                parameter) with the same 72 #5, 24 #6 and 24 #7 launches;
                (b) the same model and seeded (8, 128) batch on a 1x2 (data,
                model) mesh of two gloo ranks sharing the card: each rank's
                resident state (the allocator's requested bytes; its
                memory_allocated beside them) equal to
                launch/specs.py::tree_device_bytes, 72 #5, 24 #6 and 24 #7
                launches on every rank's heads' shard, and the step's first
                moments (the clipped gradient) no farther (relative l2)
                from the f32 unsharded step than 1.1x the bf16 unsharded
                step (phase 12's relative rule), over all of them, on the
                median leaf and on the worst leaf; (c) the SMOKE width in
                bf16 on a 2x1 mesh (FSDP over data) under the same rules (the
                f32 kernels: hd 16), and in f32 on 2x1 and 1x2 against the
                unsharded f32 step, every leaf of m and v, the loss, grad
                norm and |TD| by tests/test_torch_token_dqn.py's rules;
                (d) launch.train --mesh 16x16 --steps 2
                with phase 13's arguments: every state tensor's fingerprint
                and the history equal to phase 13's --mesh host run's, #1
                and #2 launched as there; (e) every config's state bytes per
                device at 16x16 and 2x16x16, f32 and bf16 moments, from
                shapes alone.
 27. sharded serving — prefill, decode_step, serve_step, DecodeEngine and
                ActorServer with shd: InternLM2-1.8B at full width and depth
                (bf16, flash) serving 8 requests of 128-512 tokens (bucket
                edges: every prefill takes #5) x 8 new tokens; (a) on a 1x1
                mesh of one NCCL rank in this process, the tokens, each
                prompt's prefill logits, K/V cache and next decode logits
                bit for bit the unsharded server's, 24 #5 launches a prefill
                on both; (b) on a 1x2 (data, model) mesh of two gloo ranks
                sharing the card (phase 26's ranks, their state freed): the
                prefill logits of each length no farther (relative
                l2) from the f32 model than 1.1x the unsharded bf16 logits
                (phase 21's rule), the tokens the unsharded server's but
                where its pick was a near tie (a top-2 gap within four bf16
                ulps), the same on both ranks, 24 #5 launches a prefill on
                each rank's 8 heads, each rank's cache pieces equal to
                tree_device_bytes (half the whole), one decode step's wall
                time, collectives and host-staged all-gathers printed; (c)
                launch.dryrun on InternLM2-1.8B's train_4k, prefill_32k and
                decode_32k cells at 16x16 over a fake group of 256 ranks on
                the meta device (started in a process of its own before
                phase 21): each ends ok, its three terms printed.
 28. the port's lint — (a) tools/repro_lint_torch.py --check exits 0
                (findings by rule, waivers by rule and ROADMAP item); (b)
                each step program of the lint's registry that has a card
                path (the fused and async loop steps, replay sample/update/
                flush in the lazy, eager and fused arms, the DQN, DDPG, TD3
                and SAC learns, the token-DQN train step at InternLM2's
                SMOKE width in f32 with flash, the token collect, the
                engine's prime, insert, decode step and release at
                Granite-8B's SMOKE width, Hymba's and xLSTM's SMOKE
                forwards) runs a few calls under
                torch.cuda.set_sync_debug_mode("warn"); every sync's
                innermost frame under src/repro_torch that lies in a
                registered program's scope is an R401/R404 line of the
                lint, flagged or waived (missed=0), the CartPole steps
                sync 0 times, and #1-#4 and #5b-#7b launch; (c) a .item()
                seeded into the DQN learn is recorded by the card at its
                line and flagged R404 there by the lint; (d) each entry of
                the lint's in-place table returns its argument's own
                storage on the card (ShardedExecutor.run_chunk on a gloo
                group of this one process).

Between phases 4 and 5 a torch.profiler window of 20 main-path
iterations gives the device-busy share and the ops per iteration.
Granite-8B's weights and its f32 copy are freed before phase 11; phase 12
runs before the training state and the 34.3 GB token-MDP table exist, and
each training run's state is freed before the next.  Phases 21 and 23
start each model with under 1 GiB allocated and free it before the next.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  The line before that one is
the ``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32X3_OPS_PER_S = 165e12      # f32-accurate products on its tensor cores: 3xTF32, 495 / 3
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
SEED = 0
N_TIMED = 30            # 60 until the audio phase (25) needed the time
GATE_BATCHES = 4
SERVE_REQUESTS = 8      # phase 8's Granite-8B requests (phase 21 serves the larger models)
TRAIN_STEPS = 2         # phase 13's steps before the restart's one
TRAIN_SEQ = 128         # phase 13's segment length (256 until the audio phase (25))
# (n, s, hd, attention, window, causal, is_global, dtype) of the flash
# kernels' parity phases (7 and 11): the five mask cases of
# tests/test_flash_attention.py, hd 16/96/128, a ragged S = 200, bf16; for
# #5b also 26(c)'s route (32, 128, 16) bf16, a ragged bf16 at hd 16 and the
# training shape (128, 256, 128) in f32
FLASH_CASES = [
    (4, 256, 64, "full", 0, True, True, "float32"), (4, 256, 64, "full", 0, False, True, "float32"),
    (4, 256, 64, "sliding", 64, True, False, "float32"),
    (4, 256, 64, "sliding", 64, True, True, "float32"),
    (4, 256, 64, "chunked", 64, True, False, "float32"), (8, 128, 16, "full", 0, True, True, "float32"),
    (3, 200, 128, "full", 0, True, True, "float32"), (3, 200, 96, "sliding", 50, True, False, "float32"),
    (2, 200, 64, "chunked", 48, False, False, "float32"),
    (4, 200, 64, "sliding", 64, True, False, "bfloat16"),
    (32, 128, 128, "full", 0, True, True, "bfloat16"),
    (32, 512, 128, "full", 0, True, True, "bfloat16"),
    (32, 128, 16, "full", 0, True, True, "bfloat16"),
    (3, 200, 16, "full", 0, True, True, "bfloat16"),
    (128, 256, 128, "full", 0, True, True, "float32")]
# phase 7's cases of #5b with Sk != S: (n, s, sk, hd, attention, window,
# causal, is_global, dtype)
FLASH_FWD_SK_CASES = [(2, 256, 100, 128, "full", 0, False, True, "float32"),
                      (2, 100, 300, 64, "full", 0, True, True, "float32")]
# phase 7's further bf16 cases, of the Hopper forward: the serve and train
# shapes at full size, hd 96 at a ragged S, sliding and chunked at hd 128;
# non-causal at Whisper's encoder width (16 heads x 4 rows, 1,536 frames: the
# multiple of 128 next to its 1,500) and at a ragged S, and Whisper's decoder
# in a train step (16 heads x 8 rows, 128 tokens) causal
FLASH_SM90_CASES = [
    (32, 4096, 128, "full", 0, True, True, "bfloat16"),
    (128, 256, 128, "full", 0, True, True, "bfloat16"),
    (3, 1000, 96, "full", 0, True, True, "bfloat16"),
    (4, 512, 128, "sliding", 128, True, False, "bfloat16"),
    (4, 512, 128, "chunked", 128, True, False, "bfloat16"),
    (64, 1536, 64, "full", 0, False, True, "bfloat16"),
    (3, 1000, 64, "full", 0, False, True, "bfloat16"),
    (128, 128, 64, "full", 0, True, True, "bfloat16")]


# phase 11's further backward cases, of the pair that f32 and hd 16 take
# (#6b, #7b): the wall-clock trainer's (32, 128, 16) f32 (phase 20(e)) and
# 26(c)'s route, the same shape in bf16
FLASH_PAIR_CASES = [(32, 128, 16, "full", 0, True, True, "float32"),
                    (32, 128, 16, "full", 0, True, True, "bfloat16")]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def clock(phase: str) -> None:
    """Where the script's time goes: the seconds since it was imported, as
    a phase begins."""
    print(f"[clock] phase {phase} starts at {time.perf_counter() - T_START:.1f} s", flush=True)


# -- timing and bounds ---------------------------------------------------------


def call_ms(torch, fn) -> float:
    """Median time of one call from an idle card to its last kernel's end
    (CUDA events around the call): the latency a caller sees, wrapper
    host time included."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(N_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, per_round: int = 10) -> float:
    """Median device time of one call over N_TIMED calls.  In each round
    ``per_round`` calls are queued behind a GPU sleep long enough for the
    host to enqueue them all, so they run back to back; one CUDA-event
    pair brackets each call.  Rounds stay short so that the plain
    versions' many small launches fit in the launch queue.  A round whose
    sleep ended before its calls were queued is not counted and the sleep
    is doubled; six such doublings fail."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times, factor = [], 4
    while len(times) < N_TIMED:
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(per_round + 2)]
        evs[0].record()
        torch.cuda._sleep(int((factor * per_round * host_s + 0.005) * 2e9))  # ≥ that long below 2 GHz
        evs[1].record()
        t0 = time.perf_counter()
        for i in range(per_round):
            fn()
            evs[i + 2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if evs[0].elapsed_time(evs[1]) < enqueue_ms:
            factor *= 2
            check(factor <= 4 * 2**6, "the GPU sleep ended before the timed calls were queued, "
                  "six times over")
            continue
        times += [evs[i + 1].elapsed_time(evs[i + 2]) for i in range(per_round)]
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time the card needs: bytes over memory rate or operations
    over the peak rate of their type, whichever is larger → (ms, what
    bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def rows_touched(torch, spec, leaf):
    """Distinct sibling rows the descent reads for these sampled leaves."""
    rows = 0
    for level in range(1, spec.leaf_level + 1):
        rows += int(torch.unique(leaf // spec.fanout ** (spec.leaf_level - level + 1)).numel())
    return rows


def nodes_touched(torch, spec, idx):
    """Distinct nodes an update of these leaves reads and writes."""
    nodes, cur = 0, idx
    for _ in range(spec.leaf_level + 1):
        nodes += int(torch.unique(cur).numel())
        cur = cur // spec.fanout
    return nodes


# -- phases 3 and 6: the replay kernels ------------------------------------------


def replay_tree(torch, dev, gen, capacity: int, fanout: int):
    """(spec, tree) of uniform priorities in [0.01, 2)."""
    from repro_torch.core import sumtree
    spec = sumtree.make_spec(capacity, fanout)
    pri = torch.rand((capacity,), generator=gen, device=dev) * 1.99 + 0.01
    return spec, sumtree.build(spec, pri)


def bumped(spec, tree):
    """Root and the last real level-1 parent raised coherently: every
    leaf row undershoots, so u → 1 draws clamp into the padded tail."""
    t = tree.clone()
    extra = 0.05 * float(t[0])
    t[0] += extra
    t[spec.offsets[1] + (spec.capacity - 1) // spec.fanout ** (spec.height - 1)] += extra
    return t


def replay_storage(torch, dev, gen, capacity: int, token: bool = False) -> dict:
    """CartPole's five transition leaves plus a bf16 (3, 5) one, or the
    token-DQN training path's four (256,) leaves."""
    if token:
        return {
            "tokens": torch.randint(0, 92_544, (capacity, 256), generator=gen,
                                    device=dev, dtype=torch.int32),
            "actions": torch.randint(0, 92_544, (capacity, 256), generator=gen,
                                     device=dev, dtype=torch.int32),
            "rewards": torch.rand((capacity, 256), generator=gen, device=dev),
            "dones": (torch.rand((capacity, 256), generator=gen, device=dev) < 0.01).float(),
        }
    return {
        "obs": torch.randn((capacity, 4), generator=gen, device=dev),
        "action": torch.randint(0, 2**31 - 1, (capacity,), generator=gen,
                                device=dev, dtype=torch.int32),
        "reward": torch.rand((capacity,), generator=gen, device=dev),
        "next_obs": torch.randn((capacity, 4), generator=gen, device=dev),
        "done": (torch.rand((capacity,), generator=gen, device=dev) < 0.1).float(),
        "frames": torch.randn((capacity, 3, 5), generator=gen,
                              device=dev).to(torch.bfloat16),
    }


def pendulum_storage(torch, dev, gen, capacity: int) -> dict:
    """Pendulum's five transition leaves: rows of 12, 4, 4, 12 and 4 bytes."""
    return {
        "obs": torch.randn((capacity, 3), generator=gen, device=dev),
        "action": torch.rand((capacity, 1), generator=gen, device=dev) * 4 - 2,
        "reward": -16 * torch.rand((capacity,), generator=gen, device=dev),
        "next_obs": torch.randn((capacity, 3), generator=gen, device=dev),
        "done": (torch.rand((capacity,), generator=gen, device=dev) < 0.005).float(),
    }


def nonfinite_storage(torch, dev, gen, capacity: int, drawn) -> dict:
    """f32 rows with inf, -inf and NaN in rows that are not drawn and in one
    that is (``drawn[0]``), and an int32 leaf of 2^24 + 1 and above (which
    an f32 round trip rounds)."""
    x = torch.randn((capacity, 3), generator=gen, device=dev)
    taken = torch.zeros(capacity, dtype=torch.bool, device=dev)
    taken[drawn] = True
    spare = torch.nonzero(~taken)[:6, 0]
    x[spare[:2], 0] = float("inf")
    x[spare[2:4], 1] = float("nan")
    x[spare[4:], 2] = float("-inf")
    x[drawn[0]] = torch.tensor([float("inf"), float("nan"), float("-inf")], device=dev)
    return {"x": x, "n": (2**24 + 1 + torch.arange(capacity, device=dev)).to(torch.int32)}


def same_bytes(torch, a, b) -> bool:
    """Bit for bit (NaN != NaN, so compare the bytes)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# the update's batches in phase 3: an insert, CartPole's, Nature DQN's, past
# one CTA of 1,024 updates, and three chunks
UPDATE_BATCHES = (1, 8, 64, 512, 1025, 2100)


def mixed_leaves(torch, dev, gen, n: int = 50_000) -> dict:
    """Leaves of 1-, 4-, 12-, 16- and 1,024-byte rows with row counts around
    ``n``, and views that start 4, 2 and 1 bytes into their buffers (the
    f32 (4,) rows 4 bytes off 16-byte alignment)."""
    def rows(dtype, shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return torch.randint(0, 2**31 - 1, shape, generator=gen, device=dev).to(dtype)
    return {"u8": rows(torch.uint8, (n,)), "f32": rows(torch.float32, (n - 7,)),
            "i32x3": rows(torch.int32, (n + 3, 3)), "f32x4": rows(torch.float32, (n, 4)),
            "bf16x512": rows(torch.bfloat16, (n - 1, 512)),
            "f32x4+4": rows(torch.float32, (n * 4 + 1,))[1:].view(n, 4),
            "bf16x3+2": rows(torch.bfloat16, (n * 3 + 1,))[1:].view(n, 3),
            "u8x6+1": rows(torch.uint8, (n * 6 + 1,))[1:].view(n, 6)}


def sixteen_leaves(torch, dev, gen, n: int = 50_000) -> dict:
    """The most leaves one fused launch takes: four dtypes, rows of 1-5
    elements or none, row counts n - j."""
    dtypes = (torch.float32, torch.int32, torch.bfloat16, torch.uint8)
    return {f"l{j}": torch.randint(0, 127, (n - j,) + ((j % 5 + 1,) if j % 3 else ()),
                                   generator=gen, device=dev).to(dtypes[j % 4])
            for j in range(16)}


CHAIN_ARMS = ("sample + one-leaf gathers", "sample + gather_items", "fused sample_gather",
              "searchsorted + index_select")


def sampling_chain(torch, dev, gen, capacity: int, batch: int, token: bool = False,
                   names=CHAIN_ARMS, storage=None) -> dict:
    """A learner call's sampling, timed as one unit (``device_ms`` and
    ``call_ms``) in four arms, in turns (each twice, in order and then in
    reverse; the mean of the two): the descent and one one-leaf gather
    per storage leaf (the earlier sequence, through ``prioritized_gather``);
    the descent and one ``gather_items``; the fused kernel; and the library
    yardstick, ``torch.searchsorted`` on the leaves' CDF (built outside the
    timed call, its last entry inf so every draw lands on a leaf) and one
    ``index_select`` per leaf.  ``names`` picks some of the arms;
    ``storage`` replaces CartPole's (or the token replay's) leaves."""
    from repro_torch.core import sumtree
    from repro_torch.kernels import ops
    spec, tree = replay_tree(torch, dev, gen, capacity, 128)
    if storage is None:
        storage = {k: v for k, v in replay_storage(torch, dev, gen, capacity, token).items()
                   if k != "frames"}
    leaves = list(storage.values())
    u = torch.rand((batch,), generator=gen, device=dev)
    cdf = torch.cumsum(sumtree.leaves(spec, tree), 0)
    cdf[-1] = float("inf")
    pos = torch.clamp(u, 1e-12, 1.0 - 1e-7) * tree[0]

    def one_leaf():
        idx, _ = ops.sumtree_sample(spec, tree, u)
        return [ops.prioritized_gather(b, idx) for b in leaves]

    def items():
        idx, _ = ops.sumtree_sample(spec, tree, u)
        return ops.gather_items(storage, idx)

    def library():
        idx = torch.searchsorted(cdf, pos)
        return [torch.index_select(b, 0, idx) for b in leaves]

    arms = dict(zip(CHAIN_ARMS, (one_leaf, items,
                                 lambda: ops.sumtree_sample_gather(spec, tree, u, storage),
                                 library)))
    arms = {name: fn for name, fn in arms.items() if name in names}
    runs = {name: {"device_ms": [], "call_ms": []} for name in arms}
    for name in list(arms) + list(arms)[::-1]:
        runs[name]["device_ms"].append(device_ms(torch, arms[name]))
        runs[name]["call_ms"].append(call_ms(torch, arms[name]))
    torch.cuda.synchronize()
    return {"capacity": capacity, "K": 128, "B": batch, "leaves": len(leaves),
            "arms": {name: {"device_ms": statistics.mean(r["device_ms"]),
                            "call_ms": statistics.mean(r["call_ms"]), "runs": r}
                     for name, r in runs.items()}}


# -- phases 4 and 5: the CartPole loop --------------------------------------------


def run_arm(torch, iterations: int, fused: bool, lazy: bool, capacity: int = 20_000,
            warmup: int = 400, seed: int = 1, publish_interval: int = 0):
    """FusedExecutor on CUDA with the settings of tests/test_system.py
    (CartPole × 8 envs, DQN (4, 256, 256, 2), K=128, batch 64, ε 0.2), or
    with ``publish_interval`` > 0 the AsyncExecutor on a parameter copy
    republished every ``publish_interval`` iterations: ``iterations``
    counted iterations after ``init`` → (executor, state, history, seconds,
    kernel launches of the run, calls of the run: each tree op's and
    ``learner_calls``).  Three more steps run with every synchronizing
    CUDA call an error."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec_env, _, _ = env_fn(1)
    replay = PrioritizedReplay(
        ReplayConfig(capacity=capacity, fanout=128, fused_sample_gather=fused),
        transition_example(spec_env), device="cuda")
    check(replay.ops.name == "cuda", "the CUDA device did not default to the kernels")
    cfg = LoopConfig(batch_size=64, warmup=warmup, epsilon=0.2, lazy_replay=lazy)
    agent = make_dqn(spec_env, DQNConfig())
    if publish_interval:
        # lazily: tools/replay_ab.py also runs this on older packages, which lack it
        from repro_torch.runtime.executors import AsyncExecutor
        ex = AsyncExecutor(agent, replay, env_fn, cfg, n_envs=8,
                           publish_interval=publish_interval)
    else:
        ex = FusedExecutor(agent, replay, env_fn, cfg, n_envs=8)
    return (ex, *counted_run(torch, ex, ex.init(seed), iterations,
                             f"fused={fused}, lazy={lazy}, publish_interval={publish_interval}"))


def counted_run(torch, ex, state, iterations: int, what: str):
    """``iterations`` iterations of ``ex`` from ``state`` with the kernels'
    launch counts set to 0 just before and read just after → (state,
    history, seconds, launches, calls: each tree op's and
    ``learner_calls``); then three steps with every synchronizing CUDA
    call an error."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = dict(ex.replay.ops.counts)
    learned = state.learn_steps
    t0 = time.perf_counter()
    state, hist = ex.run(state, iterations)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    calls = {k: v - before.get(k, 0) for k, v in ex.replay.ops.counts.items()}
    calls["learner_calls"] = state.learn_steps - learned
    # the step must never wait on the device: a few more steps with
    # every synchronizing CUDA call turned into an error
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, _ = ex.step(state)
    except RuntimeError as e:
        fail(f"a loop step ({what}) synchronized: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return state, hist, secs, counts, calls


def profile_loop(torch, ex, state, iterations: int = 20):
    """A torch.profiler window of ``iterations`` steady loop iterations →
    (state, {wall, device-busy and device ops per iteration, busy share,
    the top device entries}); the busy figures are None where the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = ex.run(state, iterations)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev_events)
    n_kernels = sum(e.count for e in dev_events)
    return state, {
        "iterations": iterations, "wall_us_per_iteration": wall_us / iterations,
        "device_busy_us_per_iteration": busy_us / iterations if busy_us else None,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "device_ops_per_iteration": n_kernels / iterations if busy_us else None,
        "top": [[e.key[:70], e.count / iterations, e.self_device_time_total / iterations]
                for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]],
    }


def profile_line(what: str, p: dict) -> str:
    if p["device_busy_share"] is None:
        return f"[profile] {what}: torch.profiler recorded no device time: busy share not measured"
    return (f"[profile] {what}, {p['iterations']} iterations under torch.profiler: "
            f"{p['wall_us_per_iteration']:,.0f} us wall, "
            f"{p['device_busy_us_per_iteration']:,.1f} us device-busy and "
            f"{p['device_ops_per_iteration']:,.1f} device ops per iteration (busy share "
            f"{p['device_busy_share']:.4f})")


# -- phases 7-10: flash attention and the token-model serve path ---------------


def l2_sums(got, want) -> tuple:
    """(sum |got - want|^2, sum |want|^2) in f64."""
    w = want.double()
    return float((got.double() - w).square().sum()), float(w.square().sum())


def rel_l2(pairs) -> float:
    """Relative l2 distance of all the ``got`` tensors, concatenated, from
    all the ``want`` ones: sqrt(sum |got - want|^2 / sum |want|^2), in f64."""
    num = den = 0.0
    for got, want in pairs:
        a, b = l2_sums(got, want)
        num, den = num + a, den + b
    return math.sqrt(num / den)


def profile_summary(torch, prof, wall_us: float, steps: int) -> dict:
    """Device-busy share, device ops per step and the top device ops of
    one torch.profiler window."""
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return {"steps": steps, "wall_us": wall_us, "device_busy_us": busy,
            "device_busy_share": busy / wall_us if busy else None,
            "device_ops_per_step": n / steps,
            "top": [[e.key[:70], e.count / steps, e.self_device_time_total / steps]
                    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]]}


def flash_phases(torch, dev, card: str) -> list:
    """Phases 7-10 → the two forward kernels' entries of the kernels line."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.serve import ActorServeConfig, ActorServer, BucketSpec

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def qkv(n, s, hd, dtype, sk=None):
        return [(torch.randn((n, r, hd), generator=gen, device=dev) * 0.3).to(dtype)
                for r in (s, sk or s, sk or s)]

    # 7. the forward kernels against their plain version, run in f32 on the
    # same inputs; each case goes to the kernel _fwd_kernel_for picks, and
    # #5b's are repeated bit for bit by a second call
    cases = [(n, s, s, *rest) for n, s, *rest in FLASH_CASES + FLASH_SM90_CASES]
    cases += FLASH_FWD_SK_CASES
    err = {}
    for case in cases:
        flash_fwd_case(torch, qkv, case, err)
    f32e, sm90e = err[fa.NAME], err[fa.SM90_NAME]
    print(f"[flash parity] {len(cases)} cases agree with the plain version: {fa.NAME} "
          f"{f32e['cases']} cases, each bit for bit on a second call (f32 max |err| "
          f"{f32e['f32_max_abs_err']:.3g}, atol 2e-6 + rtol 1e-4; bf16 max |err| "
          f"{f32e['bf16_max_abs_err']:.3g}, at most {f32e['bf16_max_ulps_beyond_atol']:.3f} "
          f"ulp beyond atol 2e-6); {fa.SM90_NAME} "
          f"{sm90e['cases']} cases (bf16 max |err| "
          f"{sm90e['max_abs_err']:.3g}, at most {sm90e['bf16_max_ulps_beyond_atol']:.3f} bf16 "
          f"ulp beyond atol 2e-6; 1 allowed); LSE max rel "
          f"{max(f32e['lse_max_rel'], sm90e['lse_max_rel']):.3g}", flush=True)
    torch.cuda.empty_cache()

    clock("8 (serve)")
    # 8. the serve path: Granite-8B at full width and depth through ActorServer
    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="flash")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.rope_theta) == (36, 4096, 32, 8, 128, 14336, 49152, 1e7),
          f"not Granite-8B's published shape: {cfg}")
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    scfg = ActorServeConfig(slots=8, max_len=544, buckets=(128, 256, 512), max_new_tokens=32)
    rng = np.random.RandomState(SEED)
    lens = rng.randint(1, 513, size=SERVE_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]

    def serve(c, batch, budget):
        server = ActorServer(c, params, scfg, device=dev)
        handles = [server.submit(p, budget) for p in batch]
        t0 = time.perf_counter()
        server.drain(timeout=600)
        torch.cuda.synchronize()
        return server, [h.result(0) for h in handles], time.perf_counter() - t0

    for c in (cfg, naive_cfg):    # warm cuBLAS, the allocator and the kernel: one per bucket
        serve(c, [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
                  for n in (100, 200, 400)], 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    server, done, wall = serve(cfg, prompts, 32)
    counts = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    st = server.stats()
    generated = sum(len(c.tokens) for c in done)
    check(generated == SERVE_REQUESTS * 32 == st["admissions"] + st["decoded_tokens"]
          == st["generated_tokens"] and all(len(c.tokens) == 32 for c in done),
          f"token accounting: {generated} generated, stats {st}")
    check(st["prime_compiles"] <= 3, f"{st['prime_compiles']} prefill shapes for 3 buckets")
    per_prefill = backbone.flash_launches_per_prefill(cfg)
    predicted = per_prefill * st["admissions"]       # one pass per prefill
    flash_launches = counts.get(fa.SM90_NAME, 0)
    check(flash_launches == predicted > 0 and not counts.get(fa.NAME),
          f"{fa.SM90_NAME} launches {flash_launches} on the serve path, predicted "
          f"{per_prefill} x {st['admissions']} prefills = {predicted}, and no {fa.NAME}: "
          f"{counts}")
    check(all(0 <= t < cfg.vocab_size for c in done for t in c.tokens), "token out of range")

    nserver, ndone, nwall = serve(naive_cfg, prompts, 32)
    nst = nserver.stats()
    first_agree = sum(a.tokens[0] == b.tokens[0] for a, b in zip(done, ndone))
    token_agree = sum(x == y for a, b in zip(done, ndone) for x, y in zip(a.tokens, b.tokens))
    # prefill logits at every real position: flash vs naive, and each against
    # the exact model (the same weights in f32, naive attention, TF32 off).
    # bf16 rounding alone puts naive ~2e-2 from the exact model, so flash is
    # held to naive's own distance from it (a wrong kernel lands far beyond).
    exact_cfg = dataclasses.replace(naive_cfg, dtype="float32")
    exact = backbone.Backbone(exact_cfg, dev)
    with torch.no_grad():       # one tensor at a time: 33 GB in f32 beside 16.5 in bf16
        for a, b in zip(exact.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    spec, sums = BucketSpec(scfg.buckets), {"fn": [0.0, 0.0], "fx": [0.0, 0.0], "nx": [0.0, 0.0]}
    for p in prompts:
        padded = torch.from_numpy(spec.pad(p)).to(dev).long()
        lf = backbone.prefill(cfg, params, padded, scfg.max_len)[0][0, :len(p)].float()
        ln = backbone.prefill(naive_cfg, params, padded, scfg.max_len)[0][0, :len(p)].float()
        lx = backbone.prefill(exact_cfg, exact, padded, scfg.max_len)[0][0, :len(p)]
        check(lf.shape == (len(p), cfg.vocab_size) and all(
            bool(torch.isfinite(x).all()) for x in (lf, ln, lx)), "prefill logits not finite")
        for key, a, b in (("fn", lf, ln), ("fx", lf, lx), ("nx", ln, lx)):
            sums[key] = [x + y for x, y in zip(sums[key], l2_sums(a, b))]
    del exact, lf, ln, lx
    torch.cuda.empty_cache()
    rel = {key: math.sqrt(num / den) for key, (num, den) in sums.items()}
    fn_rel = rel["fn"]
    check(rel["fx"] <= 1.1 * rel["nx"], f"flash prefill logits are {rel['fx']:.4g} relative l2 "
          f"from the f32 model, naive's {rel['nx']:.4g}: flash adds error")
    check(fn_rel < 3e-2, f"flash vs naive prefill logits differ by {fn_rel:.4g} relative l2")

    # where a request's time goes: one prefill, then 8 decode steps
    eng = server.engine
    state = eng.init_state()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        tok, slot_cache = eng.prime(params, prompts[int(np.argmax(lens))])
        state = eng.insert(state, 0, slot_cache, tok)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e6
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        for _ in range(8):
            _, state = eng.step(params, state)
        torch.cuda.synchronize()
        wall_d = (time.perf_counter() - t0) * 1e6
    prof = {"prefill": profile_summary(torch, prof_p, wall_p, 1),
            "decode": profile_summary(torch, prof_d, wall_d, 8)}
    # the Hopper forward's share of the prefill's device time
    prof["prefill"]["flash_fwd_us"] = sum(
        e.self_device_time_total for e in prof_p.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and "flash_fwd_sm90" in e.key)

    def phases(stats, secs):
        return {"first_tokens_per_s": stats["admissions"] / stats["prefill_s"],
                "decode_tokens_per_s": stats["decoded_tokens"] / stats["decode_s"],
                "latency_p50_ms": stats["latency_p50_ms"],
                "latency_p99_ms": stats["latency_p99_ms"], "prefill_s": stats["prefill_s"],
                "decode_s": stats["decode_s"], "decode_steps": stats["steps"], "wall_s": secs}

    rate = {"model": cfg.name, "params": n_params, "init_s": init_s, "requests": SERVE_REQUESTS,
            "new_tokens": 32, "slots": 8, "buckets": list(scfg.buckets),
            "max_len": scfg.max_len, "prompt_tokens": int(lens.sum()),
            "flash": phases(st, wall), "naive": phases(nst, nwall),
            "peak_memory_bytes": peak, "flash_launches": flash_launches,
            "flash_launches_predicted": predicted, "prime_compiles": st["prime_compiles"],
            "prefill_logits_rel_l2": fn_rel, "flash_vs_f32_rel_l2": rel["fx"],
            "naive_vs_f32_rel_l2": rel["nx"], "first_token_agreement": first_agree,
            "token_agreement": token_agree, "profile": prof}
    f, nf = rate["flash"], rate["naive"]
    print(f"[serve] {cfg.name} ({n_params / 1e9:.2f} B params, {cfg.dtype}, made in "
          f"{init_s:.1f} s): "
          f"{SERVE_REQUESTS} requests x 32 tokens on 8 slots, {int(lens.sum())} prompt tokens; "
          f"flash: "
          f"{f['first_tokens_per_s']:.2f} first-tokens/s, {f['decode_tokens_per_s']:.1f} decode "
          f"tokens/s, p50 {f['latency_p50_ms']:.0f} ms, p99 {f['latency_p99_ms']:.0f} ms; naive: "
          f"{nf['first_tokens_per_s']:.2f} first-tokens/s, {nf['decode_tokens_per_s']:.1f} decode "
          f"tokens/s; peak memory {peak / 2**30:.2f} GiB; flash launches {flash_launches} = "
          f"{per_prefill} x {st['admissions']} prefills x 1 pass; prefill logits flash vs "
          f"naive rel l2 {fn_rel:.4g} (each from the f32 model: flash {rel['fx']:.4g}, naive "
          f"{rel['nx']:.4g}); first tokens agree {first_agree}/{SERVE_REQUESTS}, all tokens "
          f"{token_agree}/{SERVE_REQUESTS * 32} | {card}", flush=True)
    for name, pr in prof.items():
        print(f"[serve profile] {name}: {pr['wall_us'] / pr['steps']:,.0f} us wall, "
              f"{pr['device_busy_us'] / pr['steps']:,.0f} us device-busy and "
              f"{pr['device_ops_per_step']:,.0f} device ops per step (busy share "
              f"{pr['device_busy_share']}) | {card}", flush=True)
    pp = prof["prefill"]
    print(f"[serve profile] the prefill of a {int(lens.max())}-token prompt (bucket 512): "
          f"{fa.SM90_NAME} {pp['flash_fwd_us']:,.0f} us of {pp['device_busy_us']:,.0f} us "
          f"device-busy ({pp['flash_fwd_us'] / max(pp['device_busy_us'], 1e-9):.3f}) | {card}",
          flush=True)
    print(f"[serve rate] {json.dumps(rate)}", flush=True)
    del server, nserver, eng, state, slot_cache, params
    torch.cuda.empty_cache()

    clock("9 (solo)")
    # 9. continuous batching against solo greedy decodes, f32, TF32 off
    c_cfg = dataclasses.replace(get_config("granite_8b", smoke=True), attn_impl="flash")
    check(c_cfg.dtype == "float32" and not torch.backends.cuda.matmul.allow_tf32,
          "the solo check runs in f32 with TF32 off")
    c_params = backbone.init_params(c_cfg, torch.Generator(device=dev).manual_seed(SEED + 1))
    c_serve = ActorServeConfig(slots=3, max_len=264, buckets=(128, 256), max_new_tokens=8)
    c_prompts = [rng.randint(0, c_cfg.vocab_size, size=int(n)).astype(np.int32)
                 for n in rng.randint(1, 257, size=8)]
    c_server = ActorServer(c_cfg, c_params, c_serve, device=dev)
    handles = [c_server.submit(p) for p in c_prompts]
    c_server.drain(timeout=600)
    cont = [h.result(0).tokens for h in handles]
    departures = []
    for i, p in enumerate(c_prompts):
        logits, cache = backbone.prefill(c_cfg, c_params, torch.from_numpy(p).to(dev).long()[None],
                                         c_serve.max_len)
        last = logits[0, -1]
        for t in range(c_serve.max_new_tokens):
            top2 = torch.topk(last.float(), 2).values
            margin, tok = float(top2[0] - top2[1]), int(torch.argmax(last))
            if tok != cont[i][t]:
                check(margin < 1e-5, f"request {i}, token {t}: continuous {cont[i][t]} vs solo "
                      f"{tok}, solo top-2 margin {margin:.3g} >= 1e-5")
                departures.append((i, t, margin))
                print(f"[solo] request {i} token {t}: continuous {cont[i][t]} vs solo {tok} at "
                      f"a top-2 margin of {margin:.3g} (a near tie; the rest not compared)",
                      flush=True)
                break
            lg, cache = backbone.decode_step(c_cfg, c_params, cache,
                                             torch.tensor([[tok]], device=dev))
            last = lg[0, -1]
    print(f"[solo] {c_cfg.name} f32, 8 requests x 8 tokens on 3 slots (buckets 128/256, flash "
          f"prefill): continuous = solo greedy, {len(departures)} near-tie departures",
          flush=True)

    clock("10 (flash times)")
    # 10. the forward kernels' times beside their bounds, their plain version
    # and SDPA
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_times(n, s, hd, dt, ops_per_s, kern):
        q, k, v = qkv(n, s, hd, dt)
        q4, k4, v4 = q[None], k[None], v[None]
        pairs = s * (s + 1) / 2                      # causal (query, key) pairs per head
        size = q.element_size()
        b_ms, b_by = bound(4 * n * s * hd * size + n * s * 4, 4 * hd * n * pairs, ops_per_s)
        t = {"ms": device_ms(torch, lambda: kern(q, k, v)),
             "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(q, k, v)),
             "library_ms": device_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True)),
             "bound_ms": b_ms, "bound_by": b_by, "call_ms": call_ms(torch, lambda: kern(q, k, v))}
        check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "library_ms")),
              f"timing of the flash forward at ({n}, {s}, {hd}) is not finite")
        return t

    times = {}
    for n, s in ((32, 512), (32, 4096), (128, 256)):
        t = times[(n, s)] = fwd_times(n, s, 128, bf16, BF16_OPS_PER_S, fa.flash_attention_cuda)
        print(f"[times] {fa.SM90_NAME} ({n}, {s}, 128) bf16 causal: device {t['ms'] * 1e3:.1f} us "
              f"(plain {t['plain_ms'] * 1e3:.1f} us, SDPA {t['library_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, call {t['call_ms'] * 1e3:.1f} us) "
              f"| {card}", flush=True)
    f32t = {(n, s, hd, dt): fwd_kernel_times(torch, dev, n, s, hd, dt)
            for n, s, hd, dt in ((4, 256, 64, torch.float32), (128, 256, 128, torch.float32),
                                 (32, 128, 16, bf16))}
    for t in f32t.values():
        print(f"[times] {fa.NAME} {fwd_times_line(t)} | {card}", flush=True)
    torch.cuda.empty_cache()
    return [{"name": fa.SM90_NAME, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{fa.SM90_NAME}.cu",
             "replaces": "src/repro/kernels/flash_attention.py:123", "launches": flash_launches,
             "path": "serve", "launches_per_prefill": per_prefill, **err[fa.SM90_NAME],
             **times[(32, 512)], "shape": "(32, 512, 128) bf16 causal",
             "at_32x4096": times[(32, 4096)], "at_128x256": times[(128, 256)]},
            {"name": fa.NAME, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{fa.NAME}.cu",
             "replaces": "src/repro/kernels/flash_attention.py:123",
             "launches": counts.get(fa.NAME, 0),
             "path": "20(e) f32 at hd 16 (the wall-clock trainer); 26(c) bf16 at hd 16 (the "
                     "SMOKE width on a 2x1 mesh)", **err[fa.NAME],
             **f32t[(4, 256, 64, torch.float32)],
             "at_128x256x128": f32t[(128, 256, 128, torch.float32)],
             "at_32x128x16_bf16": f32t[(32, 128, 16, bf16)]}]


def flash_fwd_case(torch, qkv, case: tuple, per_kernel: dict) -> None:
    """One of phase 7's cases, ``(n, s, sk, hd, attention, window, causal,
    is_global, dtype)``: the forward that ``_fwd_kernel_for`` picks against
    its plain version in f32 on the same inputs (``parity.flash_check``),
    one launch, and for #5b a second call bit for bit the same.
    ``qkv(n, s, hd, dtype, sk)`` makes the inputs; the kernel's worst
    errors and its count of cases go into ``per_kernel[name]``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, parity

    n, s, sk, hd, attn, win, causal, glob, dt = case
    dt = getattr(torch, dt)
    q, k, v = qkv(n, s, hd, dt, sk)
    name = fa._fwd_kernel_for(dt, hd)
    before = ops.launch_counts[name]
    o, lse = fa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
    launched = ops.launch_counts[name] - before
    o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), attn, win,
                                              causal, glob)
    torch.cuda.synchronize()
    rep = parity.flash_check(o, lse, o_ref, lse_ref)
    case = (f"{name} at ({n}, {s}, {hd}) Sk {sk} {attn} window {win} causal={causal} "
            f"global={glob} {dt}")
    check(o.dtype == dt and rep.ok and launched == 1, f"{case}: {rep}, {launched} launches")
    if name == fa.NAME:
        o2, lse2 = fa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"{case}: a second call gave another O or LSE")
    e = per_kernel.setdefault(name, {"max_abs_err": 0.0, "bf16_max_ulps_beyond_atol": 0.0,
                                     "f32_max_abs_err": 0.0, "bf16_max_abs_err": 0.0,
                                     "lse_max_rel": 0.0, "cases": 0})
    e["max_abs_err"] = max(e["max_abs_err"], rep.max_abs_err)
    key = "f32_max_abs_err" if dt == torch.float32 else "bf16_max_abs_err"
    e[key] = max(e[key], rep.max_abs_err)
    e["bf16_max_ulps_beyond_atol"] = max(e["bf16_max_ulps_beyond_atol"], rep.max_ulps)
    e["lse_max_rel"] = max(e["lse_max_rel"], rep.lse_max_rel)
    e["cases"] += 1


def fwd_parity(torch, dev) -> dict:
    """Phase 7's cases that go to #5b (f32, and hd 16), through
    ``flash_fwd_case`` → its worst errors and its cases."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def qkv(n, s, hd, dtype, sk):
        return [(torch.randn((n, r, hd), generator=gen, device=dev) * 0.3).to(dtype)
                for r in (s, sk, sk)]

    per_kernel = {}
    for case in [(n, s, s, *rest) for n, s, *rest in FLASH_CASES] + FLASH_FWD_SK_CASES:
        if fa._fwd_kernel_for(getattr(torch, case[-1]), case[3]) == fa.NAME:
            flash_fwd_case(torch, qkv, case, per_kernel)
    return per_kernel


# -- phases 11-14: the flash backward and the token-DQN training path ----------


def sdpa_backward(torch, q4, k4, v4, do4, causal: bool = True):
    """One PyTorch call that computes dQ, dK and dV of causal (or full)
    attention (the library yardstick of the dQ + dK/dV pair, never called
    by the port): the flash backend's backward, or the efficient one if
    flash refuses."""
    aten = torch.ops.aten
    try:
        out = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal)
        o, lse, cq, ck, mq, mk, seed, offset = out[:8]
        call = lambda: aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
            do4, q4, k4, v4, o, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)
        call()
        return "flash", call
    except RuntimeError:
        o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, None, True, 0.0, causal)
        return "efficient", lambda: aten._scaled_dot_product_efficient_attention_backward(
            do4, q4, k4, v4, None, o, lse, seed, offset, 0.0, [True, True, True, False],
            causal)


def same_td_grads(torch, on: dict, off: dict) -> dict:
    """Phase 12's remat check: the loss and the gradients of one batch with
    remat on and off, bit for bit or their largest difference."""
    pairs = [(on["loss"], off["loss"]), *zip(on["grads"], off["grads"])]
    return {"bit_for_bit": all(bool(torch.equal(a, b)) for a, b in pairs),
            "max_abs_diff": max(float((a.double() - b.double()).abs().max()) for a, b in pairs),
            "grads_rel_l2": rel_l2(zip(off["grads"], on["grads"])), "gradients": len(pairs) - 1}


@contextlib.contextmanager
def unwritten_saves(written_from=None):
    """``CheckpointManager.save`` and ``save_async`` observed and not
    written, for a checkpoint that nothing reads (26.4 GB at InternLM2-1.8B,
    ~30-40 s a write): yields the (step, tensor count) of each call.  With
    ``written_from`` the saves of that step and later are written too."""
    from repro_torch.checkpoint.manager import CheckpointManager

    calls = []
    real, real_async = CheckpointManager.save, CheckpointManager.save_async

    def written(step, tensors) -> bool:
        calls.append((step, len(tensors)))
        return written_from is not None and step >= written_from

    def observed(self, step, tensors, extra=None):
        if written(step, tensors):
            return real(self, step, tensors, extra)
        return os.path.join(self.dir, f"step_{step}")

    def observed_async(self, step, tensors):
        if written(step, tensors):
            real_async(self, step, tensors)

    CheckpointManager.save, CheckpointManager.save_async = observed, observed_async
    try:
        yield calls
    finally:
        CheckpointManager.save, CheckpointManager.save_async = real, real_async


def flash_bwd_case(torch, randn, case: tuple, per_kernel: dict) -> None:
    """One of phase 11's backward cases, ``(n, s, hd, attention, window,
    causal, is_global, dtype)``: the pair that ``_bwd_kernel_for`` picks
    against the plain backward in f32 on the same q, k, v, dO and the
    forward kernel's O and LSE (``parity.flash_bwd_check``), one launch of
    each of its kernels and none of the other pair, and a second call bit
    for bit the same.  ``randn(n, s, hd, dtype)`` makes the inputs; each
    kernel's worst error (dQ's own, dK/dV's over dK and dV) and its count of
    cases go into ``per_kernel[name]``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, parity

    bwd_names = (fa.DQ_SM90_NAME, fa.DKV_SM90_NAME, fa.DQ_NAME, fa.DKV_NAME)
    n, s, hd, attn, win, causal, glob, dt = case
    dt = getattr(torch, dt)
    q, k, v, do = (randn(n, s, hd, dt) for _ in range(4))
    o, lse = fa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
    chosen = fa._bwd_kernel_for(dt, hd)
    before = dict(ops.launch_counts)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, attn, win, causal, glob)
    launched = {name: ops.launch_counts[name] - before.get(name, 0) for name in bwd_names}
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, attn, win, causal, glob)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), attn, win, causal, glob)
    torch.cuda.synchronize()
    rep = parity.flash_bwd_check(*got, *ref)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    case = f"({n}, {s}, {hd}) {attn} window {win} causal={causal} global={glob} {dt}"
    check(all(t.dtype == dt for t in got) and rep.ok,
          f"flash backward {chosen} at {case}: {rep}")
    check(launched == {name: int(name in chosen) for name in bwd_names},
          f"flash backward at {case} launched {launched}, expected one each of {chosen}")
    check(same, f"flash backward {chosen} at {case}: a second call gave other gradients")
    for kern, grads in ((chosen[0], ("dq",)), (chosen[1], ("dk", "dv"))):
        e = per_kernel.setdefault(kern, {"max_abs_err": 0.0, "bf16_max_ulps_beyond_atol": 0.0,
                                         "f32_max_abs_err": 0.0, "bf16_max_abs_err": 0.0,
                                         "cases": 0})
        for g in grads:
            worst, ulps = rep.per[g]
            e["max_abs_err"] = max(e["max_abs_err"], worst)
            key = "f32_max_abs_err" if dt == torch.float32 else "bf16_max_abs_err"
            e[key] = max(e[key], worst)
            e["bf16_max_ulps_beyond_atol"] = max(e["bf16_max_ulps_beyond_atol"], ulps)
        e["cases"] += 1


def pair_parity(torch, dev) -> dict:
    """Phase 11's cases that go to #6b and #7b (f32, and hd 16), through
    ``flash_bwd_case`` → per kernel its worst errors and its cases."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def randn(n, s, hd, dtype):
        return (torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(dtype)

    per_kernel = {}
    for case in FLASH_CASES + FLASH_PAIR_CASES:
        if fa._bwd_kernel_for(getattr(torch, case[-1]), case[2])[0] == fa.DQ_NAME:
            flash_bwd_case(torch, randn, case, per_kernel)
    return per_kernel


def train_phases(torch, dev, card: str, settle=None) -> list:
    """Phases 11-14 → the dQ and dK/dV kernels' entries of the kernels line
    and the training path's launch counts.  ``settle``, where given, is
    called before phase 14's times: it waits for what ran beside 11-13."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.agents import token_dqn
    from repro_torch.agents.base import state_tensors
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import sumtree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import backbone

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    check(left < 2**30, f"{left / 2**30:.2f} GiB still allocated after the serve phases")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def randn(n, s, hd, dtype):
        return (torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(dtype)

    # 11. the backward kernels against their plain version, on the forward
    # kernel's O and LSE; the plain backward in f32 on the same inputs.  Each
    # case goes to the pair _bwd_kernel_for picks, and a second call must give
    # the same gradients bit for bit
    bwd_cases = FLASH_CASES + FLASH_SM90_CASES + FLASH_PAIR_CASES
    per_kernel = {}
    for case in bwd_cases:
        flash_bwd_case(torch, randn, case, per_kernel)
    torch.cuda.empty_cache()
    fn_err = 0.0
    for attn, win, causal, glob in (("full", 0, True, True), ("sliding", 64, True, False),
                                    ("chunked", 48, False, False)):
        q, k, v = (randn(3, 200, 64, torch.float32).requires_grad_() for _ in range(3))
        got = torch.autograd.grad(torch.sin(ops.flash_attention_nhsd(
            q, k, v, attn, win, causal, glob)).sum(), (q, k, v))
        want = torch.autograd.grad(torch.sin(fa.flash_attention_plain(
            q, k, v, attn, win, causal, glob)[0]).sum(), (q, k, v))
        for a, b in zip(got, want):
            check(bool(((a - b).abs() <= 2e-5 + 1e-3 * b.abs()).all()),
                  f"FlashAttention gradients vs autograd through the plain forward ({attn})")
            fn_err = max(fn_err, float((a - b).abs().max()))
    sm90e, f32e = per_kernel[fa.DKV_SM90_NAME], per_kernel[fa.DKV_NAME]
    sm90q, f32q = per_kernel[fa.DQ_SM90_NAME], per_kernel[fa.DQ_NAME]
    print(f"[flash bwd parity] {len(bwd_cases)} cases: dQ, dK, dV agree with the plain backward, "
          f"a second call bit for bit: the Hopper pair {sm90e['cases']} cases (bf16 max |err| dQ "
          f"{sm90q['max_abs_err']:.3g}, dK/dV {sm90e['max_abs_err']:.3g}, at most "
          f"{max(sm90e['bf16_max_ulps_beyond_atol'], sm90q['bf16_max_ulps_beyond_atol']):.3f} "
          f"bf16 ulp beyond atol 2e-5; 1 allowed); the tensor-core pair of f32 and hd 16 "
          f"{f32e['cases']} cases (f32 max |err| dQ {f32q['f32_max_abs_err']:.3g}, dK/dV "
          f"{f32e['f32_max_abs_err']:.3g}, atol 2e-5 + rtol 1e-3; bf16 at hd 16 max |err| dQ "
          f"{f32q['bf16_max_abs_err']:.3g}, dK/dV {f32e['bf16_max_abs_err']:.3g}, at most "
          f"{max(f32e['bf16_max_ulps_beyond_atol'], f32q['bf16_max_ulps_beyond_atol']):.3f} "
          f"bf16 ulp beyond atol 2e-5); FlashAttention's gradients vs autograd through the plain "
          f"forward, 3 masks at (3, 200, 64) f32: max |err| {fn_err:.3g}", flush=True)

    clock("12 (grad gate)")
    # 12. the gradient gate at full width: flash bf16 and naive bf16 against
    # the same weights in f32 (naive, TF32 off), one TD loss and its
    # gradients on each of GATE_BATCHES seeded batches.  Held to <= 1.1x
    # naive's distance: the gradients (all tensors concatenated) and the
    # per-position Q(s, a) and TD (2,048 values each).  The loss (one
    # number) and the per-sequence |TD| (8) are reported, not held: so few
    # numbers put the ratio of two bf16 noise draws anywhere, on either side
    # of 1, with a correct kernel.
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), attn_impl="flash")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
           cfg.vocab_size, cfg.rope_theta, cfg.dtype, cfg.remat)
          == (24, 2048, 16, 8, 128, 8192, 92544, 1e6, "bfloat16", True),
          f"not InternLM2-1.8B's published shape with remat: {cfg}")
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    exact_cfg = dataclasses.replace(naive_cfg, dtype="float32")
    tcfg = train.token_config()
    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    names = [n for n, _ in params.named_parameters()]
    n_params = sum(p.numel() for p in params.parameters())
    exact = backbone.Backbone(exact_cfg, dev)
    with torch.no_grad():
        for a, p in zip(exact.parameters(), params.parameters(), strict=True):
            a.copy_(p)
    layers = cfg.num_layers

    def td_grads(c, net, batch):
        loss, aux = token_dqn._td_loss(c, tcfg, net, net, batch)    # target = online
        grads = torch.autograd.grad(loss, list(net.parameters()))
        return {"loss": loss.detach().double().reshape(1), "seq_td": aux["seq_td"].double(),
                "td": aux["td"].double(), "q_sa": aux["q_sa"].double(), "grads": grads}

    held, shown = ("grads", "q_sa", "td"), ("loss", "seq_td")
    gate = []
    for bi in range(GATE_BATCHES):
        b, s = 8, 256
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                 "actions": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                 "rewards": torch.rand((b, s), generator=gen, device=dev),
                 "dones": torch.zeros((b, s), device=dev),
                 "is_weights": torch.ones((b,), device=dev)}
        ops.reset_launch_counts()
        arms = {"flash": td_grads(cfg, params, batch)}
        gate_counts = dict(ops.launch_counts)
        # the online forward, the target's and the remat's recompute of the online
        check(gate_counts.get(fa.SM90_NAME) == 3 * layers and not gate_counts.get(fa.NAME)
              and gate_counts.get(fa.DQ_SM90_NAME) == layers
              and gate_counts.get(fa.DKV_SM90_NAME) == layers
              and not gate_counts.get(fa.DQ_NAME) and not gate_counts.get(fa.DKV_NAME),
              f"one TD loss and its gradients launched {gate_counts}, expected {3 * layers} "
              f"Hopper forward (with remat) and {layers} Hopper dQ and dK/dV")
        if bi == 0:
            # remat on against off, on the same batch: the loss and every gradient
            arms["flash, no remat"] = td_grads(dataclasses.replace(cfg, remat=False), params,
                                               batch)
            remat_check = same_td_grads(torch, arms["flash"], arms["flash, no remat"])
        arms["naive"] = td_grads(naive_cfg, params, batch)
        x = td_grads(exact_cfg, exact, batch)
        row = {}
        for arm, out in arms.items():
            check(all(bool(torch.isfinite(t).all()) for t in (*out["grads"], out["td"])),
                  f"{arm} TD or gradients not finite")
            row[arm] = {k: rel_l2(zip(out[k], x[k]) if k == "grads" else [(out[k], x[k])])
                        for k in held + shown}
            row[arm]["worst_tensor"] = max((rel_l2([(g, w)]), n)
                                           for g, w, n in zip(out["grads"], x["grads"], names))
        gate.append(row)
        del arms, x, out        # out: the last arm's gradients, 3.5 GiB
        for arm in [a for a in row if a.startswith("flash")]:
            for key in held:
                check(row[arm][key] <= 1.1 * row["naive"][key],
                      f"batch {bi}: {arm} bf16 {key} are {row[arm][key]:.4g} relative l2 from "
                      f"the f32 model, naive's {row['naive'][key]:.4g}: flash adds error")
        if bi == 0:
            rc = remat_check
            print(f"[grad gate] remat on against off, batch 0: loss and {rc['gradients']} "
                  f"gradients {'bit for bit' if rc['bit_for_bit'] else 'not bit for bit'} "
                  f"(largest difference {rc['max_abs_diff']:.4g}, gradients relative l2 "
                  f"{rc['grads_rel_l2']:.4g}); without remat: "
                  + ", ".join(f"{k} {row['flash, no remat'][k]:.4g}" for k in held)
                  + " from the f32 model, within 1.1x naive's", flush=True)
        print(f"[grad gate] batch {bi}: relative l2 from the same weights in f32, flash vs "
              + ", ".join(f"{k} {row['flash'][k]:.4g} vs {row['naive'][k]:.4g} "
                          f"({row['flash'][k] / row['naive'][k]:.3f}x)" for k in held + shown)
              + f"; worst tensor flash {row['flash']['worst_tensor'][1]} "
              f"{row['flash']['worst_tensor'][0]:.4g}, naive {row['naive']['worst_tensor'][1]} "
              f"{row['naive']['worst_tensor'][0]:.4g}", flush=True)
    print(f"[grad gate] {cfg.name} bf16 with remat, (8, 256) batches, {GATE_BATCHES} batches: "
          f"flash no farther than 1.1x naive from the f32 model in {', '.join(held)} on every "
          f"batch; launches per TD loss + gradients {gate_counts} | {card}", flush=True)
    del params, exact
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    check(left < 2**30, f"{left / 2**30:.2f} GiB still allocated after the gradient gate")

    clock("13 (train)")
    # 13. the training path through its entry point, at full width and depth
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = ["--arch", "internlm2_1_8b", "--attn-impl", "flash", "--seq", str(TRAIN_SEQ),
            "--batch", "8", "--n-envs", "16", "--ckpt-every", "1", "--ckpt-dir", ckpt,
            "--seed", str(SEED)]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        # the step-1 save (save_async) observed and not written: the
        # restart reads only the last step's checkpoint
        with unwritten_saves(written_from=TRAIN_STEPS) as first_saves:
            res = train.main(argv + ["--steps", str(TRAIN_STEPS)])
        train_counts = dict(ops.launch_counts)
        hist, state = res["history"], res["state"]
        steps = len(hist)
        train_peak = res["peak_memory_bytes"] or 0
        check(steps == TRAIN_STEPS and res["start"] is None,
              f"{steps} steps, start {res['start']}")
        # a step: the online and target forwards and the remat's recompute of
        # the online one, then one backward pair, per attention layer
        want = {fa.SM90_NAME: 3 * layers * steps, fa.NAME: None,
                fa.DQ_SM90_NAME: layers * steps, fa.DKV_SM90_NAME: layers * steps,
                fa.DQ_NAME: None, fa.DKV_NAME: None}
        check(all(train_counts.get(k) == v for k, v in want.items())
              and train_counts.get("sumtree_sample", 0) >= steps
              and train_counts.get("gather", 0) >= steps
              and not train_counts.get("sumtree_update") and not train_counts.get("sample_gather"),
              f"training launches {train_counts}, expected {want} and the sample and gather "
              f"kernels on every step")
        check(all(math.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm", "q_mean")),
              "non-finite loss, grad norm or Q mean on the training path")
        # 26(d) holds launch.train --mesh 16x16 to this run
        PHASE13_HOST.update(
            argv=list(argv[:argv.index("--ckpt-every")] + argv[argv.index("--ckpt-dir") + 2:]),
            fingerprints=fingerprints(torch, state_tensors(state)),
            history=[{k: h[k] for k in ("loss", "grad_norm", "q_mean")} for h in hist],
            replay_launches={k: train_counts.get(k, 0) for k in ("sumtree_sample", "gather")})
        moved = max(float((p.detach() - t).abs().max()) for p, t in
                    zip(state.params.parameters(), state.target.parameters()))
        check(moved > 0, "the online network never moved from its target copy")
        check(res["root_after_flush"] != res["root_before_flush"],
              f"the tree's root total did not change at the flush after update_priorities "
              f"({res['root_before_flush']})")
        mgr = CheckpointManager(ckpt, keep=2)
        n_tensors = len(PHASE13_HOST["fingerprints"])
        check(first_saves == [(step, n_tensors) for step in range(1, TRAIN_STEPS + 1)]
              and mgr.all_steps() == [TRAIN_STEPS],
              f"saves {first_saves} and checkpoints {mgr.all_steps()}, expected a save of "
              f"{n_tensors} tensors at every step from 1 and step {TRAIN_STEPS}'s written")
        # the replay kernels against their plain versions on the run's own
        # tree and token rows
        replay, rst = res["replay"], res["replay_state"]
        replay_parity(torch, replay, rst, gen, "the training run")
        # where one train step's time goes
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            idx, items, w = replay.sample(rst, gen, 8)
            state, _, _ = token_dqn.train_step(res["cfg"], token_dqn.NO_SHARDING, res["tcfg"],
                                               state, dict(items, is_weights=w))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        step_prof = profile_summary(torch, prof, wall, 1)
        optimal = res["optimal_reward"]
        del res, state, replay, rst, items, w, idx, prof
        gc.collect()
        torch.cuda.empty_cache()
        # a second call resumes from the last step.  The checkpoint of the
        # last step restores into that call's fresh state bit for bit: every
        # tensor's fingerprint equals that of the first call's final state
        # (one 26.4 GB read, where a separate restore took another ~41 s).
        # Its final save is observed and not written: nothing reads it
        printed = io.StringIO()
        ops.reset_launch_counts()
        restored = {}
        setup = train.token_setup

        def observed_setup(*args, **kwargs):
            t0 = time.perf_counter()
            out = setup(*args, **kwargs)
            restored.update(seconds=time.perf_counter() - t0, start=out.start,
                            fingerprints=fingerprints(torch, state_tensors(out.state)))
            return out

        train.token_setup = observed_setup
        try:
            with contextlib.redirect_stdout(printed), unwritten_saves() as saves:
                res2 = train.main(argv + ["--steps", str(TRAIN_STEPS + 1), "--ckpt-every", "0"])
        finally:
            train.token_setup = setup
        resume_counts = dict(ops.launch_counts)
        restore_s = restored["seconds"]
        want_prints = PHASE13_HOST["fingerprints"]
        differ = [k for k, v in want_prints.items() if restored["fingerprints"].get(k) != v]
        check(restored["start"] == TRAIN_STEPS and not differ
              and len(restored["fingerprints"]) == len(want_prints),
              f"{len(differ)} of {len(want_prints)} tensors did not restore bit for bit "
              f"(fingerprints): {differ[:6]}")
        print(printed.getvalue(), end="", flush=True)
        check(f"resumed from step {TRAIN_STEPS}" in printed.getvalue()
              and res2["start"] == TRAIN_STEPS and len(res2["history"]) == 1,
              f"the second call did not resume from step {TRAIN_STEPS}: start {res2['start']}, "
              f"{len(res2['history'])} steps")
        check(saves == [(TRAIN_STEPS + 1, len(want_prints))],
              f"the resumed call's final saves {saves}, expected one at step {TRAIN_STEPS + 1} "
              f"of {len(want_prints)} tensors")
        check(resume_counts.get(fa.DQ_SM90_NAME) == layers
              and resume_counts.get(fa.SM90_NAME) == 3 * layers,
              f"resumed run launches {resume_counts}")
        peak = res2["peak_memory_bytes"] or 0
        hist2 = res2["history"]
        del res2
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rate = {"model": cfg.name, "params": n_params, "steps": steps, "seq": TRAIN_SEQ, "batch": 8,
            "n_envs": 16,
            "collect_s": [h["collect_s"] for h in hist], "train_s": [h["train_s"] for h in hist],
            "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
            "reward": [h["reward"] for h in hist], "optimal_reward": optimal,
            "train_steps_per_s": steps / sum(h["train_s"] for h in hist),
            "restore_s": restore_s, "resumed_steps": [h["step"] for h in hist2],
            "peak_memory_bytes": peak, "first_call_peak_memory_bytes": train_peak,
            "launches": train_counts, "profile": step_prof, "grad_gate": gate,
            "remat_on_vs_off": remat_check}
    print(f"[train] {cfg.name} ({n_params / 1e9:.3f} B params) bf16, flash, (8 x {TRAIN_SEQ}) "
          f"batch, 16 "
          f"actors: {steps} steps, collect {statistics.median(rate['collect_s']):.2f} s and train "
          f"step {statistics.median(rate['train_s']) * 1e3:.1f} ms (medians), "
          f"{rate['train_steps_per_s']:.3f} train steps/s of train-step time; launches "
          f"{train_counts}; the resumed call's set-up with its restore {restore_s:.1f} s, every "
          f"tensor restored bit for bit (fingerprints); resumed steps {rate['resumed_steps']}; "
          f"peak memory with remat {train_peak / 2**30:.2f} GiB (first call) and "
          f"{peak / 2**30:.2f} GiB (resumed call) | {card}", flush=True)
    print(f"[train profile] one train step: {step_prof['wall_us']:,.0f} us wall, "
          f"{step_prof['device_busy_us']:,.0f} us device-busy ({step_prof['device_busy_share']} "
          f"busy share), {step_prof['device_ops_per_step']:,.0f} device ops | {card}", flush=True)
    print(f"[train rate] {json.dumps(rate)}", flush=True)

    clock("13(b) (bf16 moments)")
    moments = bf16_moments_phase(torch, dev, card, cfg, train_peak)
    print(f"[bf16 moments rate] {json.dumps(moments)}", flush=True)

    if settle:
        t0 = time.perf_counter()
        settle()
        print(f"[beside 11-13] waited {time.perf_counter() - t0:.1f} s for 17's and 18's ranks",
              flush=True)
    clock("14 (backward times)")
    # 14. the backward kernels' times beside their bounds, their plain
    # versions and one SDPA backward call: the Hopper pair in bf16 at
    # (128, 256, 128) and (32, 4096, 128); the tensor-core pair that f32 and
    # hd 16 take (#6b, #7b) in f32 at (128, 256, 128), its own type, with the
    # bound at the 3xTF32 rate and at the FMA rate beside it, and in bf16 at
    # the same shape
    times = {}
    for n, s in ((128, 256), (32, 4096)):
        q, k, v, do = (randn(n, s, 128, torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_cuda(q, k, v)
        delta = fa.flash_delta(o, do)
        pairs = n * s * (s + 1) / 2                  # causal (query, key) pairs
        reads = 4 * n * s * 128 * 2 + 2 * n * s * 4  # q, k, v, dO; lse, delta
        backend, lib = sdpa_backward(torch, q[None], k[None], v[None], do[None])
        lib_ms = device_ms(torch, lib)
        args = (q, k, v, do, lse, delta)
        dq_plain = device_ms(torch, lambda: fa.flash_attention_dq_plain(*args))
        dkv_plain = device_ms(torch, lambda: fa.flash_attention_dkv_plain(*args))
        dq_bound = bound(reads + n * s * 128 * 2, 3 * 2 * 128 * pairs, BF16_OPS_PER_S)
        dkv_bound = bound(reads + 2 * n * s * 128 * 2, 4 * 2 * 128 * pairs, BF16_OPS_PER_S)
        # name → (launch, plain ms, bound, products a pair: the bound's, the kernel's)
        calls = {
            fa.DQ_SM90_NAME: (lambda: fa.flash_attention_dq_sm90_cuda(*args), dq_plain,
                              dq_bound, 3, 4),
            fa.DKV_SM90_NAME: (lambda: fa.flash_attention_dkv_sm90_cuda(*args), dkv_plain,
                               dkv_bound, 4, 7),
        }
        for name, (kern, plain_ms, (b_ms, b_by), work, done) in calls.items():
            ms = device_ms(torch, kern)
            t = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "library": f"one SDPA {backend} backward call (dQ, dK and dV together)",
                 "bound_ms": b_ms, "bound_by": b_by, "call_ms": call_ms(torch, kern),
                 "tflops": work * 2 * 128 * pairs / (ms * 1e-3) / 1e12,
                 "tflops_products_done": done * 2 * 128 * pairs / (ms * 1e-3) / 1e12,
                 "products_a_pair": done}
            check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "library_ms")),
                  f"timing of {name} at S={s} is not finite")
            times.setdefault(name, {})[s] = t
            print(f"[times] {name} ({n}, {s}, 128) bf16 causal: device {ms * 1e3:.1f} us "
                  f"(plain {plain_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us by {b_by}, call "
                  f"{t['call_ms'] * 1e3:.1f} us; {t['tflops']:.1f} TFLOP/s of the work, "
                  f"{t['tflops_products_done']:.1f} of its {done} products a pair); SDPA "
                  f"{backend} backward (all three gradients) {lib_ms * 1e3:.1f} us | {card}",
                  flush=True)
        new = times[fa.DQ_SM90_NAME][s]["ms"] + times[fa.DKV_SM90_NAME][s]["ms"]
        print(f"[times] Hopper backward pair ({n}, {s}, 128) bf16 causal: {new * 1e3:.1f} us, "
              f"one SDPA backward {lib_ms * 1e3:.1f} us ({new / lib_ms:.2f}x of it) | {card}",
              flush=True)
        del q, k, v, do, o, lse, delta, lib, args
        torch.cuda.empty_cache()
    pair = {"f32": f32_pair_times(torch, dev, 128, 256, 128),
            "bf16": f32_pair_times(torch, dev, 128, 256, 128, torch.bfloat16)}
    for label, by_name in pair.items():
        for name, t in by_name.items():
            fma = (f", at the FMA rate {t['bound_fma_ms'] * 1e3:.2f} us by {t['bound_fma_by']}"
                   if "bound_fma_ms" in t else "")
            print(f"[times] {name} {t['shape']}: device {t['ms'] * 1e3:.1f} us (plain "
                  f"{t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.2f} us by "
                  f"{t['bound_by']}{fma}, call {t['call_ms'] * 1e3:.1f} us; "
                  f"{t['tflops']:.1f} TFLOP/s of the work); {t['library']} "
                  f"{t['library_ms'] * 1e3:.1f} us | {card}", flush=True)
        both = sum(t["ms"] for t in by_name.values())
        lib_ms = next(iter(by_name.values()))["library_ms"]
        print(f"[times] tensor-core pair of f32 and hd 16, {t['shape']}: {both * 1e3:.1f} us, "
              f"one SDPA backward {lib_ms * 1e3:.1f} us ({both / lib_ms:.2f}x of it) | {card}",
              flush=True)
    entries = []
    for name, line, path in (
            (fa.DQ_SM90_NAME, 237, "train"), (fa.DKV_SM90_NAME, 255, "train"),
            (fa.DQ_NAME, 237, "the wall-clock trainer (f32 at hd 16), 26(c) (hd 16)"),
            (fa.DKV_NAME, 255, "the wall-clock trainer (f32 at hd 16), 26(c) (hd 16)")):
        e = per_kernel[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": train_counts.get(name, 0), "path": path,
            "launches_per_train_step": train_counts.get(name, 0) / steps,
            "max_abs_err": e["max_abs_err"], "parity_cases": e["cases"],
            "bf16_max_ulps_beyond_atol": e["bf16_max_ulps_beyond_atol"]}
        if name in times:
            entry.update(times[name][256], shape="(128, 256, 128) bf16 causal",
                         at_32x4096=times[name][4096])
        else:
            entry.update(pair["f32"][name], f32_max_abs_err=e["f32_max_abs_err"],
                         bf16_max_abs_err=e["bf16_max_abs_err"], at_bf16=pair["bf16"][name])
        entries.append(entry)
    return entries, train_counts


def replay_parity(torch, replay, rst, gen, label: str):
    """The sample and gather kernels against their plain versions on a
    run's own tree and rows, at B = 8 (a learn call's) and at 65,536
    draws: the indices under the fp-tie rule, the rows bit for bit. →
    the tie report at 65,536 draws."""
    from repro_torch.core import sumtree
    from repro_torch.kernels import ops, parity

    dev = rst.tree.device
    for draws in (8, 65_536):
        u = torch.rand((draws,), generator=gen, device=dev)
        ki, kp = ops.sumtree_sample(replay.spec, rst.tree, u)
        pi, pp = sumtree.sample(replay.spec, rst.tree, u)
        torch.cuda.synchronize()
        rep = parity.sample_ties(replay.spec, rst.tree, u, ki, pi)
        check(rep.ok, f"sumtree_sample on {label}'s tree, {draws} draws: {rep}")
        agree = ki == pi
        torch.testing.assert_close(kp[agree], pp[agree], rtol=1e-5, atol=0)
        items = ops.gather_items(rst.storage, ki)
        for key, buf in rst.storage.items():
            check(torch.equal(ops.prioritized_gather(buf, ki), buf[ki])
                  and torch.equal(items[key], buf[ki]),
                  f"gather of {label}'s {key} rows {tuple(buf.shape)} {buf.dtype}")
    print(f"[replay parity] {label}: capacity {replay.spec.capacity}, K={replay.spec.fanout}, "
          f"{rst.count} rows filled: sample indices agree with the plain descent under the "
          f"fp-tie rule at 8 and 65,536 draws ({rep.flips} flipped at 65,536, at most "
          f"{rep.allowed}), gathered rows bit for bit", flush=True)
    return rep


# the three parameters whose second bf16-moment update phase 13(b) recomputes
MOMENT_CHECKS = ("embed.tok", "units.0.attn.w.wq", "final_norm.scale")


def bf16_moments_phase(torch, dev, card: str, cfg, phase13_peak: int) -> dict:
    """Phase 13(b): InternLM2-1.8B train steps with bf16 Adam moments
    (``AdamConfig(lr=1e-4, state_dtype="bfloat16")``) on seeded (8, 256)
    batches: every moment bf16 after each step, and the second update of
    MOMENT_CHECKS bit for bit the reference's formula in plain f32 torch
    ops on the card, from that update's saved gradients, moments and
    parameters; the peak memory of one step from a fresh state, and how far
    it rises above that state, with f32 moments (remat off, then on) and
    with bf16 ones (remat on)."""
    import gc

    from repro_torch.agents import token_dqn
    from repro_torch.optim import adam

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def batch():
        b, s = 8, 256
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                "actions": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev),
                "rewards": torch.rand((b, s), generator=gen, device=dev),
                "dones": torch.zeros((b, s), device=dev),
                "is_weights": torch.ones((b,), device=dev)}

    def fresh(state_dtype):
        tcfg = token_dqn.TokenDQNConfig(gamma=0.9, accum=1, opt=adam.AdamConfig(
            lr=1e-4, state_dtype=state_dtype))
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev)
        check(left < 2**30, f"{left / 2**30:.2f} GiB allocated before a fresh 13(b) state")
        state = token_dqn.init_train_state(cfg, tcfg,
                                           torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        return tcfg, state, torch.cuda.memory_allocated(dev)

    check(cfg.remat, f"{cfg.name} trains without remat")
    # a step's peak, and its rise above the resident state (online and
    # target networks, moments), for each arm in turn
    arms = {"f32 moments, remat off": (dataclasses.replace(cfg, remat=False), None),
            "f32 moments": (cfg, None), "bf16 moments": (cfg, "bfloat16")}
    peaks, above = {}, {}
    for arm, (arm_cfg, state_dtype) in arms.items():
        tcfg, state, resident = fresh(state_dtype)
        state, metrics, _ = token_dqn.train_step(arm_cfg, token_dqn.NO_SHARDING, tcfg, state,
                                                 batch())
        torch.cuda.synchronize()
        peaks[arm] = torch.cuda.max_memory_allocated(dev)
        above[arm] = peaks[arm] - resident
        if state_dtype is None:
            del state, metrics
    peak32, peak16 = peaks["f32 moments"], peaks["bf16 moments"]
    losses = [float(metrics["loss"])]
    names = [n for n, _ in state.params.named_parameters()]
    where = [names.index(n) for n in MOMENT_CHECKS]
    saved, real_update = {}, adam.update

    def update(grads, st, params, c):       # train_step's call, its inputs kept first
        saved["inputs"] = [(grads[i].clone(), st.m[i].clone(), st.v[i].clone(),
                            params[i].detach().clone()) for i in where]
        saved["count"] = st.count.clone()
        out = real_update(grads, st, params, c)
        saved["gnorm"] = out[1]
        return out

    dtypes = {x.dtype for x in state.opt.m + state.opt.v}
    check(dtypes == {torch.bfloat16}, f"the first bf16-moment step left moments of {dtypes}")
    token_dqn.adam.update = update
    try:
        state, metrics, _ = token_dqn.train_step(cfg, token_dqn.NO_SHARDING, tcfg, state, batch())
    finally:
        token_dqn.adam.update = real_update
    losses.append(float(metrics["loss"]))
    dtypes = {x.dtype for x in state.opt.m + state.opt.v}
    check(dtypes == {torch.bfloat16}, f"the second bf16-moment step left moments of {dtypes}")
    check(all(math.isfinite(x) for x in losses), f"bf16-moment losses {losses}")
    # the reference's upd(), op for op, on the saved pre-step tensors
    oc = tcfg.opt
    count = (saved["count"] + 1).float()
    b1c, b2c = 1.0 - oc.b1 ** count, 1.0 - oc.b2 ** count
    gnorm = saved["gnorm"]
    scale = torch.minimum(torch.ones_like(gnorm), torch.div(
        torch.full_like(gnorm, oc.grad_clip), torch.maximum(gnorm, torch.full_like(gnorm, 1e-12))))
    params = list(state.params.parameters())
    same = {}
    for name, i, (g, m, v, p) in zip(MOMENT_CHECKS, where, saved["inputs"]):
        gf = g.float() * scale
        m_new = oc.b1 * m.float() + (1 - oc.b1) * gf
        v_new = oc.b2 * v.float() + (1 - oc.b2) * torch.square(gf)
        step = oc.lr * (m_new / b1c) / (torch.sqrt(v_new / b2c) + oc.eps)
        p_new = (p.float() - step).to(p.dtype)
        same[name] = [bool(torch.equal(a, b)) for a, b in (
            (params[i].detach(), p_new), (state.opt.m[i], m_new.to(m.dtype)),
            (state.opt.v[i], v_new.to(v.dtype)))]
    check(all(all(x) for x in same.values()),
          f"the second bf16-moment update is not the reference's formula bit for bit "
          f"(parameter, m, v): {same}")
    n = sum(p.numel() for p in params)
    res = {"losses": losses, "peak_memory_bytes_f32_moments": peak32,
           "peak_memory_bytes_bf16_moments": peak16,
           "peak_memory_bytes_f32_moments_remat_off": peaks["f32 moments, remat off"],
           "step_above_state_bytes": above,
           "phase13_peak_memory_bytes": phase13_peak, "params": n,
           "moment_bytes_saved_predicted": 4 * n, "checked": list(MOMENT_CHECKS)}
    print(f"[bf16 moments] {cfg.name}, AdamConfig(lr=1e-4, state_dtype='bfloat16'), 2 train steps "
          f"on (8, 256) batches: every moment bf16; the second update of "
          f"{', '.join(MOMENT_CHECKS)} is the reference's formula bit for bit (parameter, m, v); "
          f"losses {losses}; peak memory of a step {peak16 / 2**30:.2f} GiB against "
          f"{peak32 / 2**30:.2f} GiB with f32 moments (saved {(peak32 - peak16) / 2**30:.2f} "
          f"GiB; m + v at 2 B less each: {4 * n / 2**30:.2f} GiB) and "
          f"{peaks['f32 moments, remat off'] / 2**30:.2f} GiB with f32 moments and remat off; "
          f"a step above its resident state: "
          + ", ".join(f"{arm} {b / 2**30:.2f} GiB" for arm, b in above.items()) + "; "
          f"phase 13's run peaked at {phase13_peak / 2**30:.2f} GiB (its token-MDP table and "
          f"replay included) | {card}", flush=True)
    del state, saved, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- phases 15-17: the restart, the async loop and the actor-critics ---------

# one actor-critic learn step on the card against the same step on the CPU.
# Basis: both sides are f32 roundings of one step; each is printed beside
# its distance from the same step in f64 on the CPU ([actor-critic f64]).
# At 200 Pendulum iterations one DDPG |TD| element fell outside this rule
# (2.29e-5 apart) with the card 6.94e-6 from the f64 step and the CPU
# 1.59e-5 from it, TF32 off: the CPU's reduction order, not a card fault
# (tools/ddpg_f64.py; ROADMAP Queue 3 item 17)
LEARN_RTOL, LEARN_ATOL = 1e-4, 1e-5
# short enough for the script to stay well inside its time limit (the
# Pendulum returns are reported, not gated); at 200 the gate above meets the
# CPU's rounding (item 17)
PENDULUM_ITERS = 300
AC_AGENTS = ("ddpg", "td3", "sac")
# 16(c) and 18(b): the return passes 30 by iteration 256 on both paths (their
# returns a chunk, recorded in the rate lines: 40.4 and 47.6 at 256, 75.0 and
# 128.2 at 384); 700 until the hybrid and ssm phase (24), 448 until the audio
# phase (25) and 384 until the sharding phase (26) needed the time
ASYNC_ITERS = 256


def differing(torch, a: dict, b: dict) -> list:
    """Keys of ``a`` whose tensor differs from ``b``'s in any bit."""
    return [k for k in a if not same_bytes(torch, a[k].reshape(-1), b[k].reshape(-1))
            or a[k].shape != b[k].shape]


def restart_phase(torch, dev, card: str) -> dict:
    """Phase 15: tests/test_system.py's checkpoint restart on the card."""
    import shutil
    import tempfile

    from repro_torch.agents.base import state_tensors
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.kernels import ops
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime import loop

    spec, v_reset, v_step = make_vec("cartpole", 4)
    agent = make_dqn(spec, DQNConfig())
    replay = PrioritizedReplay(ReplayConfig(capacity=1024, fanout=8),
                               transition_example(spec), device="cuda")
    cfg = loop.LoopConfig(batch_size=32, warmup=64, epsilon=0.2)
    step = loop.make_step(agent, replay, v_step, cfg, 4)
    st = loop.init_loop_state(agent, replay, v_reset, 2, 4)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(30):
        st, _ = step(st)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    check(st.learn_steps > 0 and counts.get("sumtree_sample") == counts.get("gather")
          == st.learn_steps, f"restart run: {st.learn_steps} learner calls, launches {counts}")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        mgr = CheckpointManager(ckpt, keep=2)
        tensors = state_tensors(st.agent)
        saved = {k: t.detach().clone() for k, t in tensors.items()}
        mgr.save(30, tensors)
        with torch.no_grad():       # clobber every tensor of the state in place
            for t in tensors.values():
                t.fill_(float("nan") if t.is_floating_point() else 7)
        got_step, restored = mgr.restore_latest(state_tensors(st.agent))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    kinds = {k.split("/")[0] + ("/" + k.split("/")[1] if k.startswith("opt/") else "")
             for k in saved}
    bad = differing(torch, restored, saved)
    check(got_step == 30 and sorted(restored) == sorted(saved) and not bad
          and kinds == {"params", "target", "opt/count", "opt/m", "opt/v", "step"}
          and all(t.device.type == "cuda" for t in restored.values()),
          f"restart: step {got_step}, {len(bad)} tensors not bit for bit ({bad[:4]}), "
          f"kinds {sorted(kinds)}")
    learned = st.learn_steps
    st, metrics = step(st)
    loss = float(metrics["loss"])
    check(math.isfinite(loss) and st.learn_steps > learned,
          f"the step after the restore: loss {loss}, learner calls {learned} -> {st.learn_steps}")
    print(f"[restart] CartPole x 4, DQN, capacity 1,024 K=8, batch 32: 30 iterations "
          f"({learned} learner calls, launches {counts}) on the card; {len(saved)} tensors "
          f"(params, target, Adam count and moments, step) saved, clobbered with NaN and "
          f"restored bit for bit; the next step's loss {loss:.6g} | {card}", flush=True)
    return {"iterations": 30, "learner_calls": learned, "tensors": len(saved),
            "launches": counts, "loss_after_restore": loss}


def async_phase(torch, dev, card: str) -> dict:
    """Phase 16: AsyncExecutor on CartPole, with the settings of
    tests/test_async_executor.py."""
    from repro_torch.agents.base import state_tensors
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.core import sumtree
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec, _, _ = env_fn(1)
    agent = make_dqn(spec, DQNConfig())

    def mk_replay():
        return PrioritizedReplay(ReplayConfig(capacity=1024, fanout=8),
                                 transition_example(spec), device="cuda")

    # (a) publish_interval 1 against the fused executor, bit for bit
    cfg = LoopConfig(batch_size=32, warmup=8, epsilon=0.2)
    s1, h1 = FusedExecutor(agent, mk_replay(), env_fn, cfg, n_envs=4, scan_chunk=16).train(40, 7)
    s2, h2 = AsyncExecutor(agent, mk_replay(), env_fn, cfg, n_envs=4, publish_interval=1,
                           scan_chunk=16).train(40, 7)
    bad_metrics = differing(torch, h1, h2)
    bad_state = differing(torch, state_tensors(s1.agent), state_tensors(s2.agent))
    copy = {f"params/{n}": p for n, p in s2.actor_params.named_parameters()}
    check(not bad_metrics and not bad_state and int(h1["learn_steps"][-1]) > 0
          and s2.params_age == 0
          and not differing(torch, copy, state_tensors(s2.agent)),
          f"async at publish_interval 1 is not the fused run bit for bit: metrics "
          f"{bad_metrics}, state {bad_state[:4]}, age {s2.params_age}")
    # (b) publish_interval 4: ages and a frozen copy between publishes
    ex = AsyncExecutor(agent, mk_replay(), env_fn, LoopConfig(batch_size=32, warmup=0,
                       epsilon=0.2), n_envs=4, publish_interval=4, scan_chunk=1)
    state = ex.init(3)
    ages, frozen = [], []
    prev = [p.clone() for p in state.actor_params.parameters()]
    for _ in range(12):
        state, _ = ex.run_chunk(state)
        now = list(state.actor_params.parameters())
        ages.append(state.params_age)
        frozen.append(all(same_bytes(torch, a, b) for a, b in zip(prev, now)))
        prev = [p.clone() for p in now]
    check(ages == [1, 2, 3, 0] * 3 and frozen == [age != 0 for age in ages],
          f"publish_interval 4: ages {ages}, copy unchanged {frozen}")
    print(f"[async] (a) publish_interval 1 vs FusedExecutor, 40 iterations from seed 7: "
          f"{len(h1)} metrics and {len(state_tensors(s1.agent))} state tensors bit for bit, "
          f"the copy synced at age 0; (b) publish_interval 4, 12 iterations: ages {ages}, the "
          f"copy byte-identical between publishes | {card}", flush=True)
    del s1, s2, ex, state
    # (c) publish_interval 4 at the main path's settings
    ex, st, hist, secs, counts, calls = run_arm(torch, ASYNC_ITERS, fused=False, lazy=True,
                                                publish_interval=4)
    final = float(hist["mean_episode_return"][-1])
    check(final > 30.0, f"async publish_interval 4: return {final} does not beat 30")
    check(counts.get("sumtree_sample", 0) == counts.get("gather", 0) == calls["learner_calls"] > 0,
          f"async arm: launches {counts} for {calls['learner_calls']} learner calls")
    check(bool(torch.isfinite(hist["loss"]).all()), "non-finite loss on the async arm")
    check(sumtree.check_invariant(ex.replay.spec, ex.replay.flush(st.replay).tree),
          "tree invariant broken after the async arm")
    rate = {"iterations": ASYNC_ITERS, "seconds": secs, "env_steps_per_s": st.env_steps / secs,
            "learner_calls_per_s": calls["learner_calls"] / secs,
            "wall_us_per_iteration": secs / ASYNC_ITERS * 1e6, "final_return": final,
            "launches": counts, "returns_by_chunk": [round(float(x), 1)
                                                     for x in hist["mean_episode_return"]]}
    print(f"[async arm] publish_interval 4, {ASYNC_ITERS} iterations in {secs:.2f} s: "
          f"{rate['wall_us_per_iteration']:,.0f} us an iteration, {rate['env_steps_per_s']:,.1f} "
          f"env-steps/s, final return {final:.1f}, launches {counts} | {card}", flush=True)
    print(f"[async rate] {json.dumps(rate)}", flush=True)
    return rate


def copy_state(torch, agent, state, device):
    """A copy of an agent's state on ``device``: a fresh ``init`` there
    with every tensor of ``state`` copied in (the learn generators
    excepted)."""
    from repro_torch.agents.base import state_tensors
    fresh = agent.init(torch.Generator(device=device).manual_seed(0))
    skip = {f"extra/{i}" for i, x in enumerate(fresh.extra) if isinstance(x, torch.Generator)}
    src = state_tensors(state)
    with torch.no_grad():
        for k, t in state_tensors(fresh).items():
            if k not in skip:
                t.copy_(src[k])
    return fresh


def _to_f64(torch, x):
    """A copy of an agent state's floating tensors (modules, Adam moments,
    tuples of them) in f64 on the CPU; integers and generators kept."""
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x).cpu().double()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double() if x.is_floating_point() else x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_f64(torch, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_f64(torch, v) for v in x)
    return x


def learn_f64(torch, agent, state, batch, is_w, noise):
    """One ``agent.learn`` on an f64 copy of ``state`` on the CPU, with an
    f64 Adam and EMA in place of ``optim.adam``'s (which compute in f32) →
    (state, metrics, |TD|): the reference that phase 17's card and CPU
    steps are each measured against."""
    from repro_torch.optim import adam

    @torch.no_grad()
    def update(grads, st, params, cfg):
        grads = [g.double() for g in grads]
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                 if cfg.grad_clip > 0 else 1.0)
        count = st.count + 1
        b1c, b2c = 1.0 - cfg.b1 ** count.double(), 1.0 - cfg.b2 ** count.double()
        for g, m, v, p in zip(grads, st.m, st.v, params):
            g = g * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = cfg.lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if cfg.weight_decay:
                step = step + cfg.lr * cfg.weight_decay * p
            p.sub_(step)
        return adam.AdamState(count, st.m, st.v), gnorm

    @torch.no_grad()
    def ema_update(target, online, tau, where=None):
        for t, o in zip(target, online):
            new = t * (1 - tau) + o * tau
            t.copy_(new if where is None else torch.where(where, new, t))

    s64 = _to_f64(torch, state)
    kw = {} if noise is None else {"noise": _to_f64(torch, noise)}
    saved = adam.update, adam.ema_update
    adam.update, adam.ema_update = update, ema_update
    try:
        return agent.learn(s64, {k: _to_f64(torch, v) for k, v in batch.items()},
                           _to_f64(torch, is_w), **kw)
    finally:
        adam.update, adam.ema_update = saved


def f64_distances(torch, ref64, card, cpu) -> dict:
    """Each side's largest |x - f64| over the loss, |TD| and every floating
    state tensor, its largest over |TD| alone, and the |TD| elements where
    the card and the CPU differ beyond phase 17's gate, each as (card, CPU,
    f64)."""
    from repro_torch.agents.base import state_tensors
    rs, rm, rtd = ref64
    ref = {k: v.detach() for k, v in {"loss": rm["loss"], "|td|": rtd,
                                      **state_tensors(rs)}.items()}
    out = {}
    for side, (s, m, td) in (("card", card), ("cpu", cpu)):
        mine = {"loss": m["loss"], "|td|": td, **state_tensors(s)}
        out[side] = max(float((mine[k].detach().cpu().double() - ref[k]).abs().max())
                        for k in ref if ref[k].is_floating_point())
        out[side + "_td"] = float((td.detach().cpu().double() - rtd).abs().max())
    a, b = card[2].detach().cpu(), cpu[2].detach()
    far = (~torch.isclose(a, b, rtol=LEARN_RTOL, atol=LEARN_ATOL)).nonzero().flatten()
    out["far_td"] = [(float(a[i]), float(b[i]), float(rtd[i])) for i in far[:8]]
    return out


def actor_critic_run(torch, dev, card: str, name: str, iterations: int) -> dict:
    """Phase 17 for one of DDPG, TD3 and SAC on Pendulum at the settings of
    benchmarks/fig10_scalability.py with 8 envs."""
    from repro_torch.agents import ddpg, sac, td3
    from repro_torch.agents.base import state_tensors
    from repro_torch.core import sumtree
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.kernels import ops, parity
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

    make = {"ddpg": lambda s: ddpg.make_ddpg(s, ddpg.DDPGConfig()),
            "td3": lambda s: td3.make_td3(s, td3.TD3Config()),
            "sac": lambda s: sac.make_sac(s, sac.SACConfig())}[name]
    env_fn = lambda n: make_vec("pendulum", n)  # noqa: E731
    spec, _, _ = env_fn(1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17 + AC_AGENTS.index(name))
    agent = make(spec)
    replay = PrioritizedReplay(ReplayConfig(capacity=50_000, fanout=128),
                               transition_example(spec), device="cuda")
    cfg = LoopConfig(batch_size=64, warmup=64, epsilon=0.1)
    # one chunk an iteration: the history keeps every iteration's loss
    ex = FusedExecutor(agent, replay, env_fn, cfg, n_envs=8, scan_chunk=1)
    st, hist, secs, counts, calls = counted_run(torch, ex, ex.init(SEED), iterations, name)
    learner_calls = calls["learner_calls"]
    check(counts.get("sumtree_sample", 0) == counts.get("gather", 0) == learner_calls > 0
          and not counts.get("sample_gather") and not counts.get("sumtree_update"),
          f"{name}: launches {counts} for {learner_calls} learner calls")
    check(bool(torch.isfinite(hist["loss"]).all()), f"{name}: a non-finite loss")
    rst = replay.flush(st.replay)
    check(bool(torch.isfinite(rst.tree).all()) and bool(torch.isfinite(rst.max_priority))
          and sumtree.check_invariant(replay.spec, rst.tree),
          f"{name}: the priorities (|TD|) are not finite or the tree is broken")
    acts = rst.storage["action"][:rst.count]
    check(acts.shape == (rst.count, 1) and acts.dtype == torch.float32
          and bool((acts.abs() <= 2.0).all()),
          f"{name}: stored actions {tuple(acts.shape)} {acts.dtype} outside [-2, 2]")
    # the replay kernels on the run's own tree and 12/4/4/12/4-byte rows
    rows = {k: tuple(v.shape[1:]) for k, v in rst.storage.items()}
    for draws in (64, 65_536):
        u = torch.rand((draws,), generator=gen, device=dev)
        ki, kp = ops.sumtree_sample(replay.spec, rst.tree, u)
        pi, pp = sumtree.sample(replay.spec, rst.tree, u)
        fi, fp, fused = ops.sumtree_sample_gather(replay.spec, rst.tree, u, rst.storage)
        items = ops.gather_items(rst.storage, ki)
        torch.cuda.synchronize()
        for which, idx in (("sumtree_sample", ki), ("sample_gather", fi)):
            rep = parity.sample_ties(replay.spec, rst.tree, u, idx, pi)
            check(rep.ok, f"{name}: {which} on the run's tree, {draws} draws: {rep}")
        agree = ki == pi
        torch.testing.assert_close(kp[agree], pp[agree], rtol=1e-5, atol=0)
        check(torch.equal(fi, ki) and torch.equal(fp, kp),
              f"{name}: sample_gather's indices differ from the descent's")
        for key, buf in rst.storage.items():
            check(same_bytes(torch, ops.prioritized_gather(buf, ki), buf[ki])
                  and same_bytes(torch, items[key], buf[ki])
                  and same_bytes(torch, fused[key], buf[ki]),
                  f"{name}: the run's {key} rows {tuple(buf.shape)} through the gathers")
    # one learn step on the card against the same step on the CPU
    _, batch, is_w = replay.sample(rst, gen, cfg.batch_size)
    cpu_gen = torch.Generator().manual_seed(SEED + 18)
    noise = {"ddpg": None, "td3": torch.randn((64, 1), generator=cpu_gen),
             "sac": tuple(torch.randn((64, 1), generator=cpu_gen) for _ in range(2))}[name]
    results = []            # the card's, then the CPU's
    for where in (dev, torch.device("cpu")):
        kw = {} if noise is None else {"noise": (
            noise.to(where) if name == "td3" else tuple(x.to(where) for x in noise))}
        s_copy = copy_state(torch, agent, st.agent, where)
        s_copy, m, td = agent.learn(s_copy, {k: v.to(where) for k, v in batch.items()},
                                    is_w.to(where), **kw)
        results.append((s_copy, m, td))
    (cs, cm, ctd), (hs, hm, htd) = results
    # the same step in f64 on the CPU: each side's distance from it says
    # which side a difference beyond the gate belongs to (ROADMAP Queue 3
    # item 17)
    ref64 = learn_f64(torch, agent, st.agent, batch, is_w, noise)
    dist64 = f64_distances(torch, ref64, (cs, cm, ctd), (hs, hm, htd))
    print(f"[actor-critic f64] {name}, {iterations} iterations: max |x - f64| over loss, "
          f"|TD| and the state: card {dist64['card']:.3g}, CPU {dist64['cpu']:.3g}; |TD|: "
          f"card {dist64['card_td']:.3g}, CPU {dist64['cpu_td']:.3g}; the |TD| elements "
          f"outside rtol {LEARN_RTOL} / atol {LEARN_ATOL} (card, CPU, f64): "
          f"{dist64['far_td']} | {card}", flush=True)
    # every tensor the step writes (params, target, Adam count and moments,
    # step, SAC's log_alpha and its Adam state); not the generators' states
    hts = state_tensors(hs)
    pairs = [("loss", cm["loss"], hm["loss"]), ("|td|", ctd, htd)] + [
        (k, t, hts[k]) for k, t in state_tensors(cs).items() if t.dtype != torch.uint8]
    worst = {}
    for key, a, b in pairs:
        a, b = a.detach().cpu(), b.detach()
        far = ~torch.isclose(a, b, rtol=LEARN_RTOL, atol=LEARN_ATOL)
        worst[key] = (int(far.sum()), float((a - b).abs().max()))
    bad = {k: v for k, v in worst.items() if v[0]}
    check(not bad, f"{name}: a learn step on the card differs from the CPU's beyond rtol "
          f"{LEARN_RTOL} / atol {LEARN_ATOL}: {bad}")
    final = float(hist["mean_episode_return"][-1])
    res = {"iterations": iterations, "seconds": secs, "iterations_per_s": iterations / secs,
           "f64_distance": dist64,
           "wall_us_per_iteration": secs / iterations * 1e6,
           "env_steps_per_s": st.env_steps / secs, "learner_calls": learner_calls,
           "mean_return": final, "launches": counts, "rows": rows,
           "card_vs_cpu_tensors": len(pairs),
           "card_vs_cpu_max_abs": max(v[1] for v in worst.values()),
           "card_vs_cpu_grad_norm": [float(cm["grad_norm"]), float(hm["grad_norm"])]}
    print(f"[actor-critic] {name} on Pendulum x 8 (hidden 256, 256), capacity 50,000 K=128, "
          f"batch 64: {iterations} iterations in {secs:.2f} s ({res['iterations_per_s']:.2f} "
          f"iterations/s, {res['wall_us_per_iteration']:,.0f} us each), {learner_calls} "
          f"learner calls, mean return {final:.1f}; launches {counts}; rows {rows}; kernels "
          f"vs plain on the run's tree and rows hold; one learn step card vs CPU on loss, "
          f"|TD| and {len(pairs) - 2} state tensors within rtol "
          f"{LEARN_RTOL} / atol {LEARN_ATOL} (max |diff| {res['card_vs_cpu_max_abs']:.3g}) "
          f"| {card}", flush=True)
    return res


def _actor_critic_rank(rank: int, card: str, iterations: int) -> dict:
    """One agent of phase 17 in a rank of its own (``launch/mesh.py::spawn``),
    TF32 off as ``main`` sets it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return actor_critic_run(torch, torch.device("cuda", 0), card, AC_AGENTS[rank], iterations)


def actor_critic_ranks(card: str, iterations: int = PENDULUM_ITERS) -> list:
    """17's three agents, each in a process of its own on this card, the
    three at once (their loops are host-bound: one after the other they
    took 80-122 s) → each rank's result.  They touch nothing of this
    process but the card, so ``main`` runs them beside phases 11-13."""
    from repro_torch.launch import mesh as meshlib

    return meshlib.spawn(_actor_critic_rank, len(AC_AGENTS), card, iterations,
                         backend="gloo", device="cuda:0", timeout_s=600)


def actor_critic_phase(torch, dev, card: str, runs=None) -> dict:
    """Phase 17: DDPG, TD3 and SAC on Pendulum (``runs``: what
    ``actor_critic_ranks`` returned, or None to run them here); then the
    sampling chain on Pendulum's five leaves in this process."""
    runs = runs or actor_critic_ranks(card)
    out = dict(zip(AC_AGENTS, runs))
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    chain = sampling_chain(torch, dev, gen, 50_000, 64,
                           storage=pendulum_storage(torch, dev, gen, 50_000))
    print(f"[sampling chain] Pendulum's 5 leaves (12/4/4/12/4 bytes), 50,000/K=128/B=64: "
          + "; ".join(f"{n} device {a['device_ms'] * 1e3:.2f} us, call {a['call_ms'] * 1e3:.1f} us"
                      for n, a in chain["arms"].items()) + f" | {card}", flush=True)
    print(f"[actor-critic rate] {json.dumps(out)}", flush=True)
    return {"agents": out, "chain": chain}


# -- phase 18: the sharded runtime, its shards as ranks on the one card -----------

SHARDED_ITERS = 256        # 18(b): see ASYNC_ITERS
POD_ITERS = 128            # 18(c): each of the 2×2 runs


def _cartpole_dqn():
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.quickstart import transition_example
    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec, _, _ = env_fn(1)
    return env_fn, transition_example(spec), make_dqn(spec, DQNConfig())


def _sharded_ex(mesh, capacity, fanout, cfg, n_envs, scan_chunk=64, async_kw=None, **kw):
    """This rank's ShardedExecutor (or, with ``async_kw``, AsyncExecutor)
    of DQN (4, 256, 256, 2) on CartPole, its replay shard on the card."""
    from repro_torch.core.distributed import ShardedPrioritizedReplay, ShardedReplayConfig
    from repro_torch.runtime.executors import AsyncExecutor, ShardedExecutor
    env_fn, example, agent = _cartpole_dqn()
    replay = ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=capacity, fanout=fanout,
                            axis_names=mesh.axis_names), example, device="cuda")
    if async_kw:
        return AsyncExecutor(agent, replay, env_fn, cfg, n_envs, mesh=mesh,
                             scan_chunk=scan_chunk, **async_kw, **kw)
    return ShardedExecutor(agent, replay, env_fn, cfg, n_envs, mesh, scan_chunk=scan_chunk,
                           **kw)


def _replicated_on_every_rank(torch, agent_state) -> list:
    """Names of the agent state's tensors whose bytes differ from rank 0's
    (rank 0 broadcasts a copy; each rank compares its own)."""
    from repro_torch.agents.base import state_tensors
    from repro_torch.optim.collectives import broadcast_
    mine = {k: t.detach().clone() for k, t in state_tensors(agent_state).items()}
    theirs = {k: t.clone() for k, t in mine.items()}
    broadcast_(list(theirs.values()))
    return differing(torch, mine, theirs)


def _sharded_world1(rank: int) -> dict:
    """18(a), one rank over NCCL: ShardedExecutor on data_mesh(1) and on
    pod_data_mesh(1, 1) against FusedExecutor, 40 iterations from seed 7,
    with the settings of tests/test_executors.py:136-160; then three steps
    with every synchronizing CUDA call an error."""
    import torch

    from repro_torch.agents.base import state_tensors
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.launch.mesh import data_mesh, pod_data_mesh
    from repro_torch.runtime.executors import FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    env_fn, example, agent = _cartpole_dqn()
    cfg = LoopConfig(batch_size=32, warmup=8, epsilon=0.2)
    fused = FusedExecutor(agent, PrioritizedReplay(ReplayConfig(capacity=1024, fanout=8),
                                                   example, device="cuda"),
                          env_fn, cfg, 4, scan_chunk=16)
    s1, h1 = fused.train(40, 7)
    out = {"backend": torch.distributed.get_backend()}
    for name, mesh in (("data_mesh(1)", data_mesh(1)), ("pod_data_mesh(1, 1)", pod_data_mesh(1, 1))):
        ex = _sharded_ex(mesh, 1024, 8, cfg, 4, scan_chunk=16)
        s2, h2 = ex.train(40, 7)
        out[name] = {"metrics": differing(torch, h1, h2),
                     "state": differing(torch, state_tensors(s1.agent), state_tensors(s2.agent)),
                     "n_metrics": len(h2), "n_state": len(state_tensors(s2.agent)),
                     "learn_steps": s2.learn_steps}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            s2, _ = ex.step(s2)
        out["sync"] = None
    except RuntimeError as e:
        out["sync"] = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["learn_steps_after"] = s2.learn_steps
    return out


def _sharded_world2(rank: int, ckpt: str) -> dict:
    """18(b), two ranks over gloo on the one card: the transport check,
    pod_data_mesh(2, 1) ≡ data_mesh(2), then the main path's settings split
    over the two shards for SHARDED_ITERS counted iterations, its kernels against
    their plain versions on this shard's tree and rows, a profiler window
    on rank 0, and the learner state saved for 18(d)."""
    import torch
    import torch.distributed as dist

    from repro_torch.agents.base import state_tensors
    from repro_torch.checkpoint import elastic
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import sumtree
    from repro_torch.kernels import ops, parity
    from repro_torch.launch.mesh import data_mesh, pod_data_mesh
    from repro_torch.runtime.loop import LoopConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"backend": dist.get_backend()}
    # gloo takes CUDA tensors for all_reduce and broadcast (it stages them
    # through host memory itself)
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    y = torch.full((4,), float(rank), device="cuda")
    dist.broadcast(y, src=1)
    out["transport"] = {"all_reduce": x.tolist(), "broadcast": y.tolist(),
                        "device": str(x.device)}
    small = LoopConfig(batch_size=32, warmup=8, epsilon=0.2)
    runs = {}
    for name, mesh in (("data_mesh(2)", data_mesh(2)), ("pod_data_mesh(2, 1)", pod_data_mesh(2, 1))):
        st, hist = _sharded_ex(mesh, 1024, 8, small, 8, scan_chunk=16).train(40, 7)
        runs[name] = (hist, {k: t.detach().clone() for k, t in state_tensors(st.agent).items()})
    (ha, sa), (hb, sb) = runs.values()
    out["2x1"] = {"metrics": differing(torch, ha, hb), "state": differing(torch, sa, sb),
                  "learn_steps": int(ha["learn_steps"][-1])}
    # the main path's settings over 2 shards
    cfg = LoopConfig(batch_size=64, warmup=400, epsilon=0.2)
    ex = _sharded_ex(data_mesh(2), 10_000, 128, cfg, 8)
    check(ex.replay.ops.name == "cuda", "the CUDA device did not default to the kernels")
    st = ex.init(1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = dict(ex.replay.ops.counts)
    t0 = time.perf_counter()
    st, hist = ex.run(st, SHARDED_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["launches"] = dict(ops.launch_counts)
    out["calls"] = {k: v - before.get(k, 0) for k, v in ex.replay.ops.counts.items()}
    out["learner_calls"] = st.learn_steps
    out.update(seconds=secs, iterations=SHARDED_ITERS,
               return_=float(hist["mean_episode_return"][-1]),
               returns=[round(float(x), 1) for x in hist["mean_episode_return"]],
               finite=bool(torch.isfinite(hist["loss"]).all()),
               buffer=int(hist["buffer_size"][-1]))
    out["not_replicated"] = _replicated_on_every_rank(torch, st.agent)
    rst = ex.replay.flush(st.replay)
    out["invariant"] = sumtree.check_invariant(ex.replay.spec, rst.tree)
    # #1 and #2 against their plain versions on this shard's tree and rows
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19 + rank)
    reports = []
    for draws in (32, 65_536):
        u = torch.rand((draws,), generator=gen, device="cuda")
        ki, kp = ops.sumtree_sample(ex.replay.spec, rst.tree, u)
        pi, pp = sumtree.sample(ex.replay.spec, rst.tree, u)
        items = ops.gather_items(rst.storage, ki)
        torch.cuda.synchronize()
        rep = parity.sample_ties(ex.replay.spec, rst.tree, u, ki, pi)
        agree = ki == pi
        reports.append({"draws": draws, "ok": rep.ok, "flips": rep.flips,
                        "allowed": rep.allowed, "report": str(rep),
                        "pri_err": float((kp[agree] - pp[agree]).abs().max()),
                        "rows": all(same_bytes(torch, items[k], b[ki]) and
                                    same_bytes(torch, ops.prioritized_gather(b, ki), b[ki])
                                    for k, b in rst.storage.items())})
    out["parity"] = reports
    out["rows"] = {k: tuple(v.shape[1:]) for k, v in rst.storage.items()}
    # where the time goes: one profiler window on rank 0, the same 20
    # iterations unprofiled on rank 1 (the collectives pair them)
    if rank == 0:
        st, out["profile"] = profile_loop(torch, ex, st)
    else:
        st, _ = ex.run(st, 20)
    elastic.save_learner(CheckpointManager(ckpt), SHARDED_ITERS + 20, st.agent)
    if rank == 0:
        torch.save({k: t.detach().cpu() for k, t in state_tensors(st.agent).items()},
                   os.path.join(ckpt, "ref.pt"))
    return out


def _sharded_world4(rank: int) -> dict:
    """18(c), four ranks over gloo as 2×2 (pod, data): the compressed
    cross-pod reduce with bf16 inside a pod, then AsyncExecutor at publish
    interval 3 and max staleness 1 on the same mesh, POD_ITERS iterations each,
    chunk by chunk."""
    import torch

    from repro_torch.launch.mesh import pod_data_mesh
    from repro_torch.optim.compress import l2_norm
    from repro_torch.runtime.loop import LoopConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pod_data_mesh(2, 2)
    cfg = LoopConfig(batch_size=64, warmup=400, epsilon=0.2)
    out = {}
    for name, async_kw in (("sharded", None),
                           ("async", dict(publish_interval=3, max_staleness=1))):
        ex = _sharded_ex(mesh, 20_000 // 4, 128, cfg, 8, async_kw=async_kw,
                         compress_pod_reduce=True, intra_pod_dtype="bf16")
        st = ex.init(1)
        chunks, ages = [], []
        t0 = time.perf_counter()
        for _ in range(POD_ITERS // ex.scan_chunk):
            st, m = ex.run_chunk(st)
            chunks.append({"loss": float(m["loss"]), "err_norm": float(m["compress_error_norm"]),
                           "ef_norm": float(l2_norm(st.ef_error)), "learns": m["learn_steps"],
                           "return": float(m["mean_episode_return"])})
            ages.append(st.params_age)
        out[name] = {"chunks": chunks, "ages": ages, "seconds": time.perf_counter() - t0,
                     "not_replicated": _replicated_on_every_rank(torch, st.agent)}
    return out


def _elastic_world(rank: int, ckpt_in: str, ckpt_out) -> dict:
    """18(d): the learner state written at another world size restored on
    every rank (rank 0 reads, broadcasts), held bit for bit against the
    writer's copy; the replay refills and one step learns."""
    import torch

    from repro_torch.agents.base import state_tensors
    from repro_torch.checkpoint import elastic
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import data_mesh
    from repro_torch.runtime.loop import LoopConfig

    ex = _sharded_ex(data_mesh(), 1024, 8, LoopConfig(batch_size=32, warmup=64, epsilon=0.2), 4)
    st = ex.init(5)
    step = elastic.restore_learner(CheckpointManager(ckpt_in), st.agent)
    want = torch.load(os.path.join(ckpt_in, "ref.pt"))
    got = state_tensors(st.agent)
    out = {"step": step, "tensors": len(got), "differing": differing(
        torch, {k: t.detach().cpu() for k, t in got.items()}, want)}
    while st.learn_steps == 0:
        st, metrics = ex.step(st)
    out["loss"] = float(metrics["loss"])
    if ckpt_out:
        elastic.save_learner(CheckpointManager(ckpt_out), step + 1, st.agent)
        if rank == 0:
            torch.save({k: t.detach().cpu() for k, t in state_tensors(st.agent).items()},
                       os.path.join(ckpt_out, "ref.pt"))
    return out


def sharded_world4() -> list:
    """18(c)'s four ranks → their results."""
    from repro_torch.launch import mesh as meshlib

    return meshlib.spawn(_sharded_world4, 4, backend="gloo", device="cuda:0", timeout_s=900)


def sharded_ranks(c_run=None) -> dict:
    """18's worlds on the card (launch/mesh.py::spawn) → each one's ranks'
    results: (b) world 2 over gloo, then (d) from its checkpoint; beside
    them (a), and (c) unless ``c_run``, a future of ``sharded_world4``'s
    ranks, is given.  They touch nothing of this process but the card, so
    ``main`` runs them beside phases 11-13."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh as meshlib

    ckpt2 = tempfile.mkdtemp(prefix="chip_smoke_world2_")
    ckpt1 = tempfile.mkdtemp(prefix="chip_smoke_world1_")
    try:
        with ThreadPoolExecutor(2) as pool:
            c_run = c_run or pool.submit(sharded_world4)
            a_run = pool.submit(meshlib.spawn, _sharded_world1, 1, backend="nccl",
                                device="cuda:0", timeout_s=600)
            b = meshlib.spawn(_sharded_world2, 2, ckpt2, backend="gloo", device="cuda:0",
                              timeout_s=900)
            # (d) elastic: world 2's learner state at world 1, world 1's at world 2
            d1 = meshlib.spawn(_elastic_world, 1, ckpt2, ckpt1, backend="nccl",
                               device="cuda:0", timeout_s=600)
            d2 = meshlib.spawn(_elastic_world, 2, ckpt1, None, backend="gloo",
                               device="cuda:0", timeout_s=600)
            return {"a": a_run.result()[0], "b": b, "c": c_run.result(), "d1": d1, "d2": d2}
    finally:
        shutil.rmtree(ckpt2, ignore_errors=True)
        shutil.rmtree(ckpt1, ignore_errors=True)


def sharded_phase(torch, dev, card: str, ranks=None) -> dict:
    """Phase 18: the sharded runtime with its shards as ranks of
    torch.distributed on the one card (``ranks``: what ``sharded_ranks``
    returned, or None to run them here); every kernel is built before the
    first rank starts."""
    t_phase = time.perf_counter()
    res = {}
    r = ranks or sharded_ranks()
    a, b, c, d1, d2 = (r[k] for k in ("a", "b", "c", "d1", "d2"))
    t = b[0]["transport"]
    check(t["all_reduce"] == [3.0] * 4 and t["broadcast"] == [1.0] * 4
          and t["device"].startswith("cuda"),
          f"18(b) gloo on CUDA tensors: all_reduce {t['all_reduce']}, broadcast "
          f"{t['broadcast']}")
    print(f"[sharded b] transport: gloo all_reduce and broadcast on CUDA tensors "
          f"({t['device']}), staged through host memory by gloo itself; no pinned "
          f"host buffers of ours | {card}", flush=True)
    for r in b:
        check(not r["2x1"]["metrics"] and not r["2x1"]["state"] and r["2x1"]["learn_steps"] > 0,
              f"18(b) pod_data_mesh(2, 1) is not data_mesh(2) bit for bit: {r['2x1']}")
    for rank, r in enumerate(b):
        calls = r["learner_calls"]
        check(r["launches"].get("sumtree_sample", 0) == r["launches"].get("gather", 0)
              == calls > 0 and not r["launches"].get("sample_gather")
              and not r["launches"].get("sumtree_update"),
              f"18(b) rank {rank}: launches {r['launches']} for {calls} learner calls")
        check(r["finite"] and r["invariant"], f"18(b) rank {rank}: a non-finite loss or a "
              "broken tree")
        check(not r["not_replicated"], f"18(b) rank {rank}: {r['not_replicated'][:4]} "
              "differ from rank 0's")
        for p in r["parity"]:
            check(p["ok"] and p["rows"], f"18(b) rank {rank}: #1/#2 against their plain "
                  f"versions on the shard's tree, {p['draws']} draws: {p['report']}, rows "
                  f"{p['rows']}")
    ret = b[0]["return_"]
    check(ret > 30.0, f"18(b) return {ret} does not beat 30")
    secs = b[0]["seconds"]
    prof = b[0]["profile"]
    print(f"[sharded b] world 2 over gloo on cuda:0, 2 shards x 4 envs, capacity 10,000 "
          f"a shard K=128, batch 32 a shard: {SHARDED_ITERS} iterations in {secs:.2f} s "
          f"beside phases 11-13 and 17's, 18(a)'s and (c)'s ranks ({SHARDED_ITERS / secs:.2f} "
          f"iterations/s, {secs / SHARDED_ITERS * 1e6:,.0f} us "
          f"each), return {ret:.1f}, learner calls {b[0]['learner_calls']} a shard, "
          f"launches {[r['launches'] for r in b]}; parameters, target, Adam state and "
          f"step byte-identical on both ranks; #1/#2 against their plain versions on each "
          f"shard's tree ({[[p['flips'] for p in r['parity']] for r in b]} flips, within "
          f"the rule); pod_data_mesh(2, 1) = data_mesh(2) bit for bit over 40 iterations; "
          f"no no-sync gate: gloo stages each collective through the host | {card}",
          flush=True)
    print(profile_line("sharded world 2, rank 0", prof), flush=True)
    res["b"] = b
    # (c) world 4 over gloo as 2×2 pod×data
    for name in ("sharded", "async"):
        for rank, r in enumerate(c):
            chunks = r[name]["chunks"]
            learning = [ch for ch in chunks if ch["learns"] > 0]
            check(learning and all(math.isfinite(ch["loss"]) for ch in chunks),
                  f"18(c) {name} rank {rank}: {chunks}")
            check(all(ch["err_norm"] > 0 for ch in learning),
                  f"18(c) {name} rank {rank}: compress_error_norm 0 after learning began")
            norms = [ch["ef_norm"] for ch in learning]
            check(all(x != y for x, y in zip(norms, norms[1:])),
                  f"18(c) {name} rank {rank}: the EF buffer's norm did not change "
                  f"between chunks: {norms}")
            check(not r[name]["not_replicated"],
                  f"18(c) {name} rank {rank}: {r[name]['not_replicated'][:4]} differ")
        rank0 = c[0][name]
        print(f"[sharded c] world 4 over gloo, 2x2 pod x data, {name}: int8-EF across "
              f"pods, bf16 inside, {POD_ITERS} iterations in {rank0['seconds']:.2f} s beside "
              f"phases 11-13 and 18(a), (b) and (d); "
              f"finite losses; rank 0's compress_error_norm "
              f"{[round(ch['err_norm'], 6) for ch in rank0['chunks']]} and EF norm "
              f"{[round(ch['ef_norm'], 6) for ch in rank0['chunks']]}, a chunk each; "
              f"replicated state byte-identical on the 4 ranks | {card}", flush=True)
    ages = [r["async"]["ages"][-1] for r in c]
    check(len(set(ages)) > 1 and all(a < 3 for a in ages),
          f"18(c) async: the shards' ages {ages} are not staggered under 3")
    print(f"[sharded c] async at publish interval 3, max staleness 1: the shards' ages "
          f"at the end {ages} | {card}", flush=True)
    res["c"] = c
    # (d) elastic
    for where, rs, want in (("world 2 -> 1", d1, SHARDED_ITERS + 20),
                            ("world 1 -> 2", d2, SHARDED_ITERS + 21)):
        for rank, r in enumerate(rs):
            check(r["step"] == want and not r["differing"] and math.isfinite(r["loss"]),
                  f"18(d) {where} rank {rank}: step {r['step']} (want {want}), not bit for "
                  f"bit {r['differing'][:4]}, loss {r['loss']}")
    print(f"[sharded d] elastic: world 2's learner state restored at world 1 (NCCL) and "
          f"world 1's at world 2 (gloo), {d1[0]['tensors']} tensors (parameters, target, "
          f"Adam count and moments, step) bit for bit on every rank; after the replay "
          f"refilled, one more step's loss {d1[0]['loss']:.6g} / {d2[0]['loss']:.6g} | {card}",
          flush=True)
    res["d"] = {"world1": d1, "world2": d2}
    for name in ("data_mesh(1)", "pod_data_mesh(1, 1)"):
        r = a[name]
        check(not r["metrics"] and not r["state"] and r["learn_steps"] > 0,
              f"18(a) ShardedExecutor({name}) is not FusedExecutor bit for bit: metrics "
              f"{r['metrics']}, state {r['state'][:4]}, learner calls {r['learn_steps']}")
    check(a["sync"] is None
          and a["learn_steps_after"] > a["pod_data_mesh(1, 1)"]["learn_steps"],
          f"18(a) a sharded step over NCCL synchronized with the host: {a['sync']}")
    print(f"[sharded a] world 1 over {a['backend']}: ShardedExecutor on data_mesh(1) and on "
          f"pod_data_mesh(1, 1) against FusedExecutor, 40 iterations from seed 7 (4 envs, "
          f"capacity 1,024 K=8, batch 32): {a['data_mesh(1)']['n_metrics']} metrics and "
          f"{a['data_mesh(1)']['n_state']} state tensors bit for bit; three more steps with "
          f"learning under set_sync_debug_mode('error'): no host sync | {card}", flush=True)
    res["a"] = a
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[sharded] phase 18 in {res['seconds']:.1f} s after its ranks", flush=True)
    print(f"[sharded rate] {json.dumps({'iterations': SHARDED_ITERS, 'seconds': secs, 'iterations_per_s': SHARDED_ITERS / secs, 'wall_us_per_iteration': secs / SHARDED_ITERS * 1e6, 'return': ret, 'returns_by_chunk': b[0]['returns'], 'launches': [r['launches'] for r in b], 'profile': prof})}", flush=True)
    return res


# -- phase 19: the replay service, its roles as processes on the one card ------

SERVICE_LEARN_STEPS = 1400     # 19(a): the reference's run length, never shortened
SERVICE_RESTART_STEPS = 200    # 19(b): the 2-shard fused gang, restarted at 100 (400 until PR 27)
SERVICE_EXEC_ITERS = 200       # 19(c): ServiceExecutor against FusedExecutor
SERVICE_GANG = dict(n_actors=2, samples_per_insert=8.0, batch_size=64, warmup=400,
                    n_envs=8, actor_chunk=8, epsilon=0.2, seed=1, device="cuda")


def spi_band(kv: dict) -> tuple:
    """(debt, error buffer) of a server's result: the band theorem
    |realized − spi| ≤ error_buffer / (inserts − min) in its exact form
    |samples − spi·(inserts − min)| ≤ error_buffer."""
    past = int(kv["INSERTS"]) - int(kv["MIN_SIZE_TO_SAMPLE"])
    return int(kv["SAMPLES"]) - float(kv["CONFIGURED_SPI"]) * past, float(kv["ERROR_BUFFER"])


def service_launches(kv: dict) -> dict:
    """A process's replay kernel launches (its ``LAUNCH_<KERNEL>`` lines:
    a service server's, a wall-clock gang rank's), by kernel name."""
    return {name: int(kv[f"LAUNCH_{name.upper()}"])
            for name in ("sumtree_sample", "gather", "sample_gather", "sumtree_update")}


def service_gangs() -> tuple:
    """19(a) and (b), one gang after the other → ((results, seconds) of
    each).  They touch nothing of this process but the card, so ``main``
    runs them beside phases 15-16, 22 and 19(c)."""
    import shutil
    import tempfile

    from repro_torch.launch import multiprocess as mp

    t0 = time.perf_counter()
    a = mp.launch_service(learn_steps=SERVICE_LEARN_STEPS, capacity_per_shard=20_000,
                          timeout_s=420.0, **SERVICE_GANG)
    secs = time.perf_counter() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        t0 = time.perf_counter()
        b = mp.launch_service(n_shards=2, fused_sample_gather=True, router="round_robin",
                              learn_steps=SERVICE_RESTART_STEPS, capacity_per_shard=10_000,
                              ckpt_dir=ckpt, ckpt_every=100,
                              restart_learner_after=SERVICE_RESTART_STEPS // 2,
                              timeout_s=420.0, **SERVICE_GANG)
        secs_b = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return (a, secs), (b, secs_b)


def service_phase(torch, dev, card: str, gangs=None) -> dict:
    """Phase 19: the replay service (src/repro_torch/service) through
    launch/multiprocess.py::launch_service, server, actors and learner
    each a process on this card and meeting over localhost TCP
    (``gangs``: a future of what ``service_gangs`` returns, or None to run
    them here); first, in process, ServiceExecutor against FusedExecutor
    and an ActorServer fed by the service's params channel."""
    import numpy as np

    from repro_torch.agents.base import state_tensors
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.configs import get_config
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import FusedExecutor
    from repro_torch.runtime.loop import LoopConfig
    from repro_torch.serve import ActorServeConfig, ActorServer
    from repro_torch.service import ReplayService, ReplayServiceConfig, ServiceExecutor
    from repro_torch.service.client import as_numpy

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = {}
    # (c) in process: ServiceExecutor ≡ FusedExecutor bit for bit on the card
    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec_env, _, _ = env_fn(1)
    example = transition_example(spec_env)
    agent = make_dqn(spec_env, DQNConfig())
    cfg = LoopConfig(batch_size=64, warmup=400, epsilon=0.2)
    fused = FusedExecutor(agent, PrioritizedReplay(ReplayConfig(capacity=20_000, fanout=128),
                                                   example, device="cuda"), env_fn, cfg, 8)
    fs, fh = fused.train(SERVICE_EXEC_ITERS, SEED + 3)
    svc = ReplayService(ReplayServiceConfig(capacity_per_shard=20_000, fanout=128), example,
                        device="cuda")
    ex = ServiceExecutor(agent, svc, env_fn, cfg, 8)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ss, sh = ex.train(SERVICE_EXEC_ITERS, SEED + 3)
    torch.cuda.synchronize()
    exec_launches = dict(ops.launch_counts)
    diff_state = differing(torch, state_tensors(fs.agent), state_tensors(ss.agent))
    diff_hist = differing(torch, fh, sh)
    diff_replay = differing(torch, {"tree": fs.replay.tree, **fs.replay.storage},
                            {"tree": ss.replay[0].tree, **ss.replay[0].storage})
    check(not diff_state and not diff_hist and not diff_replay and ss.learn_steps == fs.learn_steps > 0
          and torch.equal(ss.obs, fs.obs),
          f"19(c) ServiceExecutor is not FusedExecutor bit for bit: state {diff_state[:4]}, "
          f"history {diff_hist}, replay {diff_replay}, learner calls {ss.learn_steps} vs "
          f"{fs.learn_steps}")
    check(svc.replay.ops.name == "cuda" and exec_launches.get("sumtree_sample") ==
          exec_launches.get("gather") == ss.learn_steps,
          f"19(c) ServiceExecutor launches {exec_launches} for {ss.learn_steps} learner calls")
    print(f"[service c] ServiceExecutor (1 shard, RateLimiter.from_schedule) against "
          f"FusedExecutor on the card, {SERVICE_EXEC_ITERS} iterations at the main path's "
          f"settings from one seed: {len(state_tensors(ss.agent))} state tensors, "
          f"{len(sh)} metrics, the tree and the storage bit for bit; {ss.learn_steps} learner "
          f"calls, launches {exec_launches} | {card}", flush=True)
    res["c"] = {"launches": exec_launches, "learner_calls": ss.learn_steps}
    del fused, fs, fh, ex, ss, sh, svc
    # an ActorServer whose param_source is a ReplayService: a version put mid-run
    s_cfg = get_config("granite_8b", smoke=True)
    model = backbone.init_params(s_cfg, torch.Generator(device=dev).manual_seed(SEED + 5))
    fresh = backbone.init_params(s_cfg, torch.Generator(device=dev).manual_seed(SEED + 6))
    psvc = ReplayService(ReplayServiceConfig(capacity_per_shard=8),
                         {"obs": torch.zeros((2,))}, device="cuda")
    s_server = ActorServer(s_cfg, model, ActorServeConfig(slots=2, max_len=16, buckets=(8,),
                                                          max_new_tokens=4, idle_wait_s=0.005),
                           params_version=0, param_source=psvc, device=dev)
    rng = np.random.RandomState(SEED + 7)
    try:
        s_server.start()
        for h in [s_server.submit(rng.randint(0, s_cfg.vocab_size, size=5)) for _ in range(3)]:
            h.result(timeout=300)
        psvc.put_params(pickle.dumps(as_numpy(fresh)))
        done = [h.result(timeout=300) for h in
                [s_server.submit(rng.randint(0, s_cfg.vocab_size, size=5)) for _ in range(3)]]
    finally:
        s_server.stop()
        psvc.stop()
    st = s_server.stats()
    live, version, _ = s_server.params.swap_if_staged()
    same = all(torch.equal(x, y) for x, y in zip(live.state_dict().values(),
                                                  fresh.state_dict().values()))
    check(st["params_version"] == 1 and st["param_swaps"] == 1 and same
          and live is not model and any(c.params_version == 1 for c in done)
          and next(live.parameters()).device.type == "cuda",
          f"19(c) the ActorServer did not swap to the service's version: {st['swap_log']}, "
          f"versions {[c.params_version for c in done]}, params equal {same}")
    print(f"[service c] ActorServer ({s_cfg.name}, f32, on {dev}) with a ReplayService as "
          f"param_source: version 1 put mid-run, swapped at step {st['swap_log']}, "
          f"{st['completed']} requests completed, the live model's "
          f"{len(live.state_dict())} tensors equal to the published | {card}", flush=True)
    # (a) and (b): the gangs, waited for here where they ran beside this process
    (a, secs), (b, secs_b) = gangs.result() if gangs else service_gangs()
    # (a) the 1-shard gang at the main path's width: #1 and #2 once a sample
    server, learner = a["server"], a["learner"]
    debt, eb = spi_band(server)
    launches = service_launches(server)
    calls = int(server["SAMPLE_CALLS"])
    check(server["DEVICE"].startswith("cuda") and server["TREE_BACKEND"] == "cuda"
          and learner["DEVICE"].startswith("cuda")
          and all(a[f"actor-{i}"]["DEVICE"].startswith("cuda") for i in range(2)),
          f"19(a) a role did not run on the card: {server['DEVICE']}, {learner['DEVICE']}")
    check(abs(debt) <= eb, f"19(a) the rate limiter left its band: debt {debt}, error buffer {eb} "
          f"(realized spi {server['REALIZED_SPI']}, tolerance {server['SPI_TOLERANCE']})")
    check(int(learner["LEARN_STEPS"]) == calls == SERVICE_LEARN_STEPS,
          f"19(a) {learner['LEARN_STEPS']} learn steps, {calls} samples")
    check(launches["sumtree_sample"] == launches["gather"] == calls
          and not launches["sample_gather"] and not launches["sumtree_update"],
          f"19(a) server launches {launches} for {calls} samples: want one descent and one "
          "gather a sample, no fused or update kernel")
    ret = float(learner["EVAL_RETURN"])
    check(ret > 30.0, f"19(a) the gang's eval return {ret} does not beat 30")
    wall_ms = float(learner["WALL_PER_LEARN_MS"])
    split = {k: float(learner[f"{k.upper()}_MS_PER_LEARN"]) for k in ("sample", "learn", "update")}
    print(f"[service a] 1 server + 2 actors (8 envs, chunks of 8) + 1 learner, each a process on "
          f"{server['DEVICE']}, over localhost TCP: DQN (4, 256, 256, 2), replay 20,000 x K=128, "
          f"batch 64, spi 8, warmup 400: {calls} learn steps, eval return {ret:.1f}, realized spi "
          f"{float(server['REALIZED_SPI']):.4f} (tolerance {float(server['SPI_TOLERANCE']):.4f}), "
          f"{server['INSERTS']} inserts in {server['APPENDS']} appends; wall {wall_ms:.2f} ms a "
          f"learn step (the sample round trip {split['sample']:.2f}, the learn call to its TD "
          f"on the host {split['learn']:.2f}, the write-back {split['update']:.2f}; "
          f"{float(learner['LEARN_WALL_S']):.2f} s of learning, the gang "
          f"{secs:.1f} s with its start, beside 15-16, 22 and 19(c)); server launches "
          f"{launches}; "
          f"{int(server['SAMPLE_HOST_COPIES']) / calls:.0f} device-to-host copies a sample (five "
          f"leaves and the weights) | {card}", flush=True)
    res["a"] = {"seconds": secs, "wall_ms_per_learn": wall_ms, "ms_per_learn": split, "learn_s":
                float(learner["LEARN_WALL_S"]), "return": ret, "launches": launches,
                "samples": calls, "realized_spi": float(server["REALIZED_SPI"]),
                "spi_tolerance": float(server["SPI_TOLERANCE"]),
                "inserts": int(server["INSERTS"]), "appends": int(server["APPENDS"]),
                "host_copies_per_sample": int(server["SAMPLE_HOST_COPIES"]) / calls}
    # (b) 2 shards, each sampled by #3, and the learner restart drill
    server, first, learner = b["server"], b["learner-0"], b["learner"]
    debt, eb = spi_band(server)
    launches_b = service_launches(server)
    calls = int(server["SAMPLE_CALLS"])
    half = SERVICE_RESTART_STEPS // 2
    check(first.get("EXITED_EARLY") == "1" and int(first["LEARN_STEPS"]) == half
          and int(learner["RESUMED_FROM"]) == half
          and int(learner["LEARN_STEPS"]) == SERVICE_RESTART_STEPS == calls,
          f"19(b) the learner restart: first {first}, resumed {learner.get('RESUMED_FROM')}, "
          f"{learner.get('LEARN_STEPS')} learn steps, {calls} samples")
    check(abs(debt) <= eb, f"19(b) the rate limiter left its band: debt {debt}, error buffer {eb}")
    check(launches_b["sample_gather"] == 2 * calls and not launches_b["sumtree_sample"]
          and not launches_b["gather"] and not launches_b["sumtree_update"],
          f"19(b) server launches {launches_b} for {calls} samples of 2 shards: want two fused "
          "launches a sample and no other kernel")
    counts = [int(c) for c in server["PER_SHARD_COUNT"].split(",")]
    check(len(counts) == 2 and min(counts) > 0, f"19(b) shard counts {counts}")
    print(f"[service b] 2 shards (10,000 each, round robin), fused sample+gather, learner "
          f"restarted at {half}: resumed from {learner['RESUMED_FROM']}, {calls} learn steps in "
          f"all, eval return {float(learner['EVAL_RETURN']):.1f}, realized spi "
          f"{float(server['REALIZED_SPI']):.4f} (tolerance {float(server['SPI_TOLERANCE']):.4f}), "
          f"shard counts {counts}; server launches {launches_b}; wall "
          f"{float(learner['WALL_PER_LEARN_MS']):.2f} ms a learn step after the restart; the gang "
          f"{secs_b:.1f} s, beside 15-16, 22 and 19(c) | {card}", flush=True)
    res["b"] = {"seconds": secs_b, "launches": launches_b, "samples": calls,
                "wall_ms_per_learn": float(learner["WALL_PER_LEARN_MS"]),
                "return": float(learner["EVAL_RETURN"]), "counts": counts}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[service] phase 19 in {res['seconds']:.1f} s, the gangs' wait included", flush=True)
    print(f"[service rate] {json.dumps({k: res[k] for k in ('a', 'b', 'c')})}", flush=True)
    return res


# -- phase 20: the DSE, the planner and the wall-clock gang on the one card ------

DSE_LANES = (1, 2, 4, 8)        # 20(a): the profiled lane counts (fig12_dse's)
DSE_ITERS = 100                 # 20(a): the plan-built executor's run (200 until PR 25)
GANG_FUSED_ITERS = 30           # 20(b): tests/test_multiprocess.py's degenerate launch
GANG_BENCH = ["--mode", "bench", "--n-data", "2", "--n-envs", "8", "--iters", "12",
              "--repeats", "3", "--scan-chunk", "20"]      # 20(c) (24 iters until PR 27)
WALLCLOCK_STEPS = 3             # 20(e): each worker's train steps


def dse_actor_throughput(torch, dev, lanes: int) -> float:
    """benchmarks/fig12_dse.py's actor curve on the card: 10 act + env
    steps of ``lanes`` CartPole envs with the port's DQN, ending in a
    sync → env steps/s."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.runtime import dse

    spec, v_reset, v_step = make_vec("cartpole", lanes)
    agent = make_dqn(spec, DQNConfig())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    agent_state = agent.init(gen)
    env_state, obs = v_reset(gen)

    def fn():
        nonlocal env_state, obs
        for _ in range(10):
            a = agent.act(agent_state, obs, gen, 0.1)
            env_state, obs, _, _, _ = v_step(env_state, a, gen)
        torch.cuda.synchronize()

    return dse.measure_throughput(fn, 10 * lanes)


def dse_learner_throughput(torch, dev, lanes: int) -> float:
    """benchmarks/fig12_dse.py's learner curve on the card: 10 learn calls
    of the port's DQN at batch 32·lanes, ending in a sync → batch items/s."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.runtime import dse

    spec, _, _ = make_vec("cartpole", 1)
    agent = make_dqn(spec, DQNConfig())
    agent_state = agent.init(torch.Generator(device=dev).manual_seed(SEED))
    b = 32 * lanes
    batch = {"obs": torch.zeros((b, 4), device=dev),
             "action": torch.zeros((b,), dtype=torch.int32, device=dev),
             "reward": torch.ones((b,), device=dev), "next_obs": torch.zeros((b, 4), device=dev),
             "done": torch.zeros((b,), device=dev)}
    weights = torch.ones((b,), device=dev)

    def fn():
        nonlocal agent_state
        for _ in range(10):
            agent_state, _, _ = agent.learn(agent_state, batch, weights)
        torch.cuda.synchronize()

    return dse.measure_throughput(fn, 10 * b)


def f32_pair_times(torch, dev, n: int, s: int, hd: int, dtype=None) -> dict:
    """#6b and #7b (the dQ and dK/dV kernels that ``_bwd_kernel_for`` gives
    f32 and hd 16) at (n, s, hd) causal in ``dtype`` (f32 by default):
    device and call time, plain version, one SDPA backward (dQ, dK and dV
    together) on the same inputs, and the bound, by kernel name.  The
    bound's operations (3 and 4 products of 2·hd flops a causal pair) go at
    the tensor cores' rate for f32-accurate products (3xTF32) in f32, with
    the FMA rate's bound beside it, and at the bf16 rate in bf16."""
    from repro_torch.kernels import flash_attention as fa

    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    q, k, v, do = ((torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(dtype)
                   for _ in range(4))
    o, lse = fa.flash_attention_cuda(q, k, v)
    delta = fa.flash_delta(o, do)
    es = q.element_size()
    pairs = n * s * (s + 1) / 2                  # causal (query, key) pairs
    reads = 4 * n * s * hd * es + 2 * n * s * 4  # q, k, v, dO; lse, delta
    f32 = dtype == torch.float32
    backend, lib = sdpa_backward(torch, q[None], k[None], v[None], do[None])
    lib_ms = device_ms(torch, lib)
    args = (q, k, v, do, lse, delta)
    shape = f"({n}, {s}, {hd}) {'f32' if f32 else 'bf16'} causal"
    out = {}
    for name, kern, plain, work, nout in (
            (fa.DQ_NAME, fa.flash_attention_dq_cuda, fa.flash_attention_dq_plain, 3, 1),
            (fa.DKV_NAME, fa.flash_attention_dkv_cuda, fa.flash_attention_dkv_plain, 4, 2)):
        nbytes, ops_ = reads + nout * n * s * hd * es, work * 2 * hd * pairs
        b_ms, b_by = bound(nbytes, ops_, TF32X3_OPS_PER_S if f32 else BF16_OPS_PER_S)
        ms = device_ms(torch, lambda: kern(*args))
        t = {"shape": shape, "ms": ms, "plain_ms": device_ms(torch, lambda: plain(*args)),
             "library_ms": lib_ms,
             "library": f"one SDPA {backend} backward call (dQ, dK and dV together)",
             "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
             "call_ms": call_ms(torch, lambda: kern(*args)),
             "tflops": ops_ / (ms * 1e-3) / 1e12}
        if f32:
            t["bound_fma_ms"], t["bound_fma_by"] = bound(nbytes, ops_, F32_OPS_PER_S)
        check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "library_ms")),
              f"timing of {name} at {shape} is not finite")
        out[name] = t
    return out


def fwd_kernel_times(torch, dev, n: int, s: int, hd: int, dtype=None) -> dict:
    """#5b (the forward that ``_fwd_kernel_for`` gives f32 and hd 16) at
    (n, s, hd) causal in ``dtype`` (f32 by default): device and call time,
    plain version, SDPA's forward on the same inputs, and the bound.  The
    bound's operations (2 products of 2·hd flops a causal pair) go at the
    tensor cores' rate for f32-accurate products (3xTF32) in f32, with the
    FMA rate's bound beside it, and at the bf16 rate in bf16."""
    from repro_torch.kernels import flash_attention as fa

    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    q, k, v = ((torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(dtype)
               for _ in range(3))
    pairs = n * s * (s + 1) / 2                  # causal (query, key) pairs
    nbytes, ops_ = 4 * n * s * hd * q.element_size() + n * s * 4, 4 * hd * pairs
    f32 = dtype == torch.float32
    b_ms, b_by = bound(nbytes, ops_, TF32X3_OPS_PER_S if f32 else BF16_OPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kern = lambda: fa.flash_attention_cuda(q, k, v)  # noqa: E731
    ms = device_ms(torch, kern)
    t = {"shape": f"({n}, {s}, {hd}) {'f32' if f32 else 'bf16'} causal", "ms": ms,
         "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(q, k, v)),
         "library_ms": device_ms(torch, lambda: sdpa(q[None], k[None], v[None], is_causal=True)),
         "library": "SDPA", "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
         "call_ms": call_ms(torch, kern), "tflops": ops_ / (ms * 1e-3) / 1e12}
    if f32:
        t["bound_fma_ms"], t["bound_fma_by"] = bound(nbytes, ops_, F32_OPS_PER_S)
    check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "library_ms")),
          f"timing of {fa.NAME} at {t['shape']} is not finite")
    return t


def fwd_times_line(t: dict) -> str:
    """One of ``fwd_kernel_times``'s records as a line of text."""
    fma = (f", {t['bound_fma_ms'] * 1e3:.3f} us at the FMA rate by {t['bound_fma_by']}"
           if "bound_fma_ms" in t else "")
    return (f"{t['shape']}: device {t['ms'] * 1e3:.2f} us, call {t['call_ms'] * 1e3:.2f} us "
            f"(plain {t['plain_ms'] * 1e3:.1f} us, SDPA {t['library_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']}{fma})")


def f32_flash_times(torch, dev, n: int, s: int, hd: int) -> dict:
    """#5b, #6b and #7b (the f32 kernels) at (n, s, hd) f32 causal, the
    wall-clock trainer's shape: device time, plain version, the library
    (SDPA forward; one SDPA backward for dQ, dK and dV together) and the
    bound, by kernel name (``fwd_kernel_times``, ``f32_pair_times``)."""
    from repro_torch.kernels import flash_attention as fa

    return {fa.NAME: fwd_kernel_times(torch, dev, n, s, hd),
            **f32_pair_times(torch, dev, n, s, hd)}


def dse_phase(torch, dev, card: str) -> dict:
    """Phase 20: Eq. 5 on the card's own lane curves, the planner's plan
    built by executor_from_plan and run on the card; the wall-clock gang
    (launch/multiprocess.py) in its three modes, its ranks processes on
    this card over gloo; and launch/train.py --wall-clock 2."""
    import shutil
    import tempfile

    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import multiprocess as mp
    from repro_torch.launch import train
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime import dse, planner
    from repro_torch.runtime.executors import FusedExecutor, executor_from_plan
    from repro_torch.runtime.loop import LoopConfig

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = {}
    # (a) the lane curves, Eq. 5 and the plan, built and run on the card
    t0 = time.perf_counter()
    actor = dse.profile_curve(lambda x: dse_actor_throughput(torch, dev, x), list(DSE_LANES))
    learner = dse.profile_curve(lambda x: dse_learner_throughput(torch, dev, x),
                                list(DSE_LANES))
    solves = {ui: planner.solve_lanes(actor, learner, total=8, update_interval=ui)
              for ui in (1.0, 4.0)}
    pc = planner.plan(actor_curve=actor, learner_curve=learner, total_lanes=8,
                      update_interval=1, source="chip_smoke")
    profile_s = time.perf_counter() - t0
    check(all(math.isfinite(v) and v > 0 for v in list(actor.values()) + list(learner.values())),
          f"20(a) lane curves not finite and positive: {actor}, {learner}")
    check(pc.backend == "fused" and pc.n_envs == solves[1.0].x_actor >= 1
          and pc.x_actor + pc.x_learner <= 8,
          f"20(a) the curve-only plan is not the Eq. 5 split: {pc}, {solves[1.0]}")
    print(f"[dse a] lane curves on {dev} (fig12_dse's: 10 act+env steps of x CartPole envs; 10 "
          f"learn calls at batch 32x): actor env-steps/s "
          f"{ {x: round(v, 1) for x, v in actor.items()} }, learner items/s "
          f"{ {x: round(v, 1) for x, v in learner.items()} }; Eq. 5 at total 8: "
          + "; ".join(f"update_interval {ui:g}: x_actor {r.x_actor}, x_learner {r.x_learner}, "
                      f"ratio {r.ratio:.4f}, error {r.ratio_error:.4f}"
                      for ui, r in solves.items())
          + f"; plan: {pc.describe()} ({profile_s:.1f} s to profile) | {card}", flush=True)
    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec_env, _, _ = env_fn(1)
    agent = make_dqn(spec_env, DQNConfig())
    cfg = LoopConfig(batch_size=64, warmup=64, epsilon=0.1)
    ex = executor_from_plan(pc, agent, env_fn, cfg, transition_example(spec_env),
                            capacity=20_000, fanout=128, device="cuda")
    check(isinstance(ex, FusedExecutor) and ex.replay.ops.name == "cuda" and ex.n_envs == pc.n_envs,
          f"20(a) executor_from_plan built {type(ex).__name__} on {ex.replay.ops.name}")
    state, hist, secs, counts, calls = counted_run(torch, ex, ex.init(SEED + 11), DSE_ITERS,
                                                   "the plan-built executor")
    realized = DSE_ITERS * pc.n_envs / secs
    learned = calls["learner_calls"]
    check(learned > 0 and counts.get("sumtree_sample", 0) == counts.get("gather", 0) == learned
          and not counts.get("sample_gather") and not counts.get("sumtree_update"),
          f"20(a) launches {counts} for {learned} learner calls: want one descent and one "
          "gather a learner call")
    check(bool(torch.isfinite(hist["loss"]).all()), "20(a) a non-finite loss")
    print(f"[dse a] executor_from_plan -> {type(ex).__name__} on {ex.device}, {pc.n_envs} envs, "
          f"DQN (4, 256, 256, 2), replay 20,000 x K=128, batch 64, warmup 64: {DSE_ITERS} "
          f"iterations in {secs:.2f} s, realized {realized:,.1f} env-steps/s against the "
          f"predicted {pc.predicted_env_steps_per_s:,.1f} (the actor curve alone), {learned} "
          f"learner calls, launches {counts}; no host sync in a step | {card}", flush=True)
    res["a"] = {"actor_curve": actor, "learner_curve": learner,
                "solves": {str(ui): dataclasses.asdict(r) for ui, r in solves.items()},
                "plan": pc.to_dict(), "realized_env_steps_per_s": realized, "seconds": secs,
                "learner_calls": learned, "launches": counts, "profile_s": profile_s}
    del ex, state, hist
    # (b), (d) and (e) check results, not speed: their gangs start together,
    # each process's start (~8-14 s) overlapping the others'
    args = ["--mode", "fused", "--iters", str(GANG_FUSED_ITERS), "--n-envs", "8",
            "--scan-chunk", "10", "--seed", str(SEED)]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_wallclock_")
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(3) as pool:
            fut_b = pool.submit(mp.launch, args, n_procs=1, timeout_s=300.0, device="cuda")
            fut_d = pool.submit(mp.launch, ["--mode", "equiv", "--seed", str(SEED)],
                                n_procs=2, timeout_s=300.0, device="cuda")
            fut_e = pool.submit(train.main, [
                "--arch", "granite_8b", "--smoke", "--attn-impl", "flash", "--seq", "128",
                "--steps", str(WALLCLOCK_STEPS), "--ckpt-every", "0", "--ckpt-dir", ckpt,
                "--wall-clock", "2"])
            # (b)'s yardstick: the same executor in this process
            replay = PrioritizedReplay(ReplayConfig(capacity=50_000, fanout=128),
                                       transition_example(spec_env), device="cuda")
            fused = FusedExecutor(make_dqn(spec_env, DQNConfig()), replay, env_fn,
                                  LoopConfig(batch_size=64, warmup=64, epsilon=0.1), 8,
                                  scan_chunk=10)
            fs, fh = fused.train(GANG_FUSED_ITERS, SEED)
            kv = mp.parse_kv(fut_b.result()[0])
            kv_d = mp.parse_kv(fut_d.result()[0])
            out = fut_e.result()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    secs_bde = time.perf_counter() - t0
    # (b) --mode fused, one process on the card, against the same executor here
    want = {"FINAL_LOSS": float(fh["loss"][-1]),
            "FINAL_RETURN": float(fh["mean_episode_return"][-1]),
            "ENV_STEPS": int(fh["env_steps"][-1]),
            "PARAMS_CHECKSUM": mp.params_checksum(fs.agent.params)}
    got = {k: type(v)(kv[k]) for k, v in want.items()}
    fused_launches = service_launches(kv)
    check(got == want and kv["DEVICE"].startswith("cuda"),
          f"20(b) --mode fused on {kv.get('DEVICE')} is not FusedExecutor bit for bit: {got} "
          f"against {want}")
    check(fused_launches["sumtree_sample"] == fused_launches["gather"] == int(kv["LEARN_CALLS"])
          == fs.learn_steps > 0, f"20(b) launches {fused_launches} for {kv['LEARN_CALLS']} "
          "learner calls")
    print(f"[dse b] --mode fused, 1 process on {kv['DEVICE']} through the tcp:// handshake, "
          f"{GANG_FUSED_ITERS} iterations: loss, return, env steps and the parameter checksum "
          f"bit for bit those of FusedExecutor in this process ({want}); launches "
          f"{fused_launches} for {kv['LEARN_CALLS']} learner calls; (b), (d) and (e) together "
          f"{secs_bde:.1f} s with their starts | {card}", flush=True)
    res["b"] = {"seconds_b_d_e": secs_bde, "launches": fused_launches, "result": got}
    del fused, fs, fh, replay
    torch.cuda.empty_cache()
    # (d) --mode equiv, 2 processes: the overlapped against the barrier reduce
    shift, tele = float(kv_d["SHIFT_MAX_ABS_ERR"]), float(kv_d["TELESCOPE_MAX_ABS_ERR"])
    check(shift == 0.0 and tele < 1e-6 and kv_d["DEVICE"].startswith("cuda"),
          f"20(d) equiv on {kv_d.get('DEVICE')}: shift {shift}, telescoping {tele}")
    print(f"[dse d] --mode equiv, 2 processes on {kv_d['DEVICE']} over gloo, a (pod,) group: "
          f"SHIFT_MAX_ABS_ERR {shift!r} (want 0), TELESCOPE_MAX_ABS_ERR {tele!r} (want < 1e-6) "
          f"| {card}", flush=True)
    res["d"] = {"shift": shift, "telescope": tele}
    # (e) launch.train --wall-clock 2 at granite_8b SMOKE with flash: the f32 kernels
    outs = out["workers"]
    kvs = [mp.parse_kv(o) for o in outs]
    layers = 2      # granite_8b SMOKE, with remat: three forwards a step
    want_flash = {fa.NAME: 3 * layers * WALLCLOCK_STEPS, fa.DQ_NAME: layers * WALLCLOCK_STEPS,
                  fa.DKV_NAME: layers * WALLCLOCK_STEPS, fa.SM90_NAME: 0,
                  fa.DQ_SM90_NAME: 0, fa.DKV_SM90_NAME: 0}
    flash = [{name: int(k[f"LAUNCH_{name.upper()}"]) for name in want_flash} for k in kvs]
    check(all("arch=granite-smoke" in o and "device=cuda" in o for o in outs)
          and f"trained {WALLCLOCK_STEPS} steps" in outs[0],
          f"20(e) the workers' output: {[o[-600:] for o in outs]}")
    check(kvs[0]["PARAMS_CHECKSUM"] == kvs[1]["PARAMS_CHECKSUM"]
          and kvs[0]["PARAMS_SUM"] == kvs[1]["PARAMS_SUM"]
          and kvs[0]["PRE_AVERAGE_SUM"] != kvs[1]["PRE_AVERAGE_SUM"],
          f"20(e) the workers' parameters after the last average: {kvs}")
    check(all(f == want_flash for f in flash),
          f"20(e) flash launches {flash}; the code predicts {want_flash} on each worker")
    print(f"[dse e] launch.train --arch granite_8b --smoke --attn-impl flash --seq 128 "
          f"--wall-clock 2: 2 workers on the card over gloo, {WALLCLOCK_STEPS} steps each, "
          f"parameters averaged after every step; after the last average both checksums "
          f"{kvs[0]['PARAMS_CHECKSUM']} (sums before it {kvs[0]['PRE_AVERAGE_SUM']} and "
          f"{kvs[1]['PRE_AVERAGE_SUM']}, after {kvs[0]['PARAMS_SUM']}); flash launches per "
          f"worker {flash} (#5b/#6b/#7b: the f32 kernels at hd 16) | {card}", flush=True)
    # what #5b-#7b cost there: each worker's learner attends over (8 sequences
    # x 4 heads, 128 tokens, hd 16) in f32
    times = f32_flash_times(torch, dev, 8 * 4, 128, 16)
    for name, t in times.items():
        fma = (f"; at the FMA rate {t['bound_fma_ms'] * 1e3:.4f} us by {t['bound_fma_by']}"
               if "bound_fma_ms" in t else "")
        print(f"[dse e] {name} at {t['shape']}, the wall-clock trainer's shape: device "
              f"{t['ms'] * 1e3:.2f} us (plain {t['plain_ms'] * 1e3:.1f} us, {t['library']} "
              f"{t['library_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.4f} us by "
              f"{t['bound_by']}{fma}) | {card}", flush=True)
    res["e"] = {"flash_launches": flash, "times": times,
                "checksum": float(kvs[0]["PARAMS_CHECKSUM"])}
    # (c) --mode bench, 2 ranks over gloo on the card, alone: plain and the host publish
    res["c"] = {}
    for label, extra in (("plain", []), ("publish 3", ["--publish-interval", "3"])):
        t0 = time.perf_counter()
        outs = mp.launch(GANG_BENCH + extra, n_procs=2, timeout_s=300.0, device="cuda")
        secs_c = time.perf_counter() - t0
        kvs = [mp.parse_kv(o) for o in outs]
        launches = [service_launches(k) for k in kvs]
        for rank, (k, ln) in enumerate(zip(kvs, launches)):
            check(k["DEVICE"].startswith("cuda") and ln["sumtree_sample"] == ln["gather"]
                  == int(k["LEARN_CALLS"]) > 0 and not ln["sample_gather"]
                  and not ln["sumtree_update"],
                  f"20(c) {label} rank {rank}: launches {ln} for {k['LEARN_CALLS']} learner "
                  f"calls on {k['DEVICE']}")
        if extra:
            check(all(int(k["PARAMS_AGE"]) == 0 for k in kvs),
                  f"20(c) {label}: ages {[k['PARAMS_AGE'] for k in kvs]} after the last host "
                  "publish")
        rate, spread = float(kvs[0]["STEPS_PER_S"]), float(kvs[0]["REL_SPREAD"])
        print(f"[dse c] --mode bench {label}, 2 ranks on {kvs[0]['DEVICE']} over gloo, data "
              f"mesh of 2 (8 envs, replay 25,000 x K=128 a shard, batch 32 a shard): "
              f"STEPS_PER_S {rate:.2f} (median of {kvs[0]['REPEATS']}, REL_SPREAD "
              f"{spread:.4f}), launches per rank {launches} for {kvs[0]['LEARN_CALLS']} learner "
              f"calls each; recorded, not gated; {secs_c:.1f} s with its start | {card}",
              flush=True)
        res["c"][label] = {"steps_per_s": rate, "rel_spread": spread, "launches": launches,
                           "learner_calls": int(kvs[0]["LEARN_CALLS"]), "seconds": secs_c}
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[dse] phase 20 in {res['seconds']:.1f} s", flush=True)
    print(f"[dse rate] {json.dumps({k: res[k] for k in ('a', 'b', 'c', 'd', 'e')})}", flush=True)
    return res


# -- phase 21: Qwen1.5-32B and Command-R-35B served at full width ------------------

# (arch, its published shape: layers, d_model, heads, KV heads, hd, d_ff, vocab,
# RoPE theta, qkv bias, norm)
BIG_DENSE = (("qwen1_5_32b", (64, 5120, 40, 40, 128, 27392, 152064, 1e6, True, "rmsnorm")),
             ("command_r_35b", (40, 8192, 64, 8, 128, 22528, 256000, 8e6, False, "layernorm")))
BIG_SERVE = dict(slots=8, max_len=544, buckets=(128, 256, 512), max_new_tokens=16)
BIG_REQUESTS = 8
EXACT_LAYERS = 4        # 21(a): the exactness check's depth
EXACT_PROMPTS = 4


def prefill_logits(torch, backbone, cfg, params, prompt, spec, max_len, dev):
    """The prefill logits of ``prompt`` at its real positions (bucket-padded
    as the server pads it), in f32, and the cache."""
    padded = torch.from_numpy(spec.pad(prompt)).to(dev).long()
    logits, cache = backbone.prefill(cfg, params, padded, max_len)
    return logits[0, :len(prompt)].float(), cache


def flash_fwd_times(torch, dev, gen, n: int, s: int, hd: int = 128, attention: str = "full",
                    window: int = 0, is_global: bool = True, parity: bool = False,
                    causal: bool = True) -> dict:
    """The Hopper forward at (n, s, hd) bf16, causal (or not), under
    ``attention``'s mask: device, plain and SDPA times beside the bound
    (phase 10's measure; the bound counts the (query, key) pairs the mask
    reaches, and SDPA takes the same mask, as ``is_causal`` where it is the
    causal one and none where every pair is reached).  With
    ``parity`` the kernel is first held to its plain version in f32 on the
    same inputs under ``parity.flash_check``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parity as par

    q, k, v = [(torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
               for _ in range(3)]
    q4, k4, v4 = q[None], k[None], v[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask_args = (attention, window, causal, is_global)
    pos = torch.arange(s, device=dev)
    mask = fa.attention_mask(pos, pos, *mask_args)
    pairs = int(mask.sum())
    full = pairs == s * s
    is_causal = pairs == s * (s + 1) // 2
    label = ("causal" if is_causal and attention == "full" else "non-causal" if full else
             f"causal, {attention} {window}{', global' if is_global else ''}")
    if full:
        def lib():
            return sdpa(q4, k4, v4)
    elif is_causal:
        def lib():
            return sdpa(q4, k4, v4, is_causal=True)
    else:
        def lib():
            return sdpa(q4, k4, v4, attn_mask=mask)
    b_ms, b_by = bound(4 * n * s * hd * 2 + n * s * 4, 4 * hd * n * pairs, BF16_OPS_PER_S)
    t = {"shape": f"({n}, {s}, {hd}) bf16 {label}", "pairs": pairs}
    if parity:
        o, lse = fa.flash_attention_cuda(q, k, v, *mask_args)
        o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), *mask_args)
        torch.cuda.synchronize()
        rep = par.flash_check(o, lse, o_ref, lse_ref)
        check(rep.ok, f"{fa.SM90_NAME} at {t['shape']}: {rep}")
        t.update(max_abs_err=rep.max_abs_err, bf16_max_ulps_beyond_atol=rep.max_ulps)
        del o, lse, o_ref, lse_ref
    t.update(ms=device_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, *mask_args)),
             plain_ms=device_ms(torch, lambda: fa.flash_attention_plain(q, k, v, *mask_args)),
             library_ms=device_ms(torch, lib), bound_ms=b_ms, bound_by=b_by,
             call_ms=call_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, *mask_args)))
    check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "library_ms")),
          f"timing of the flash forward at {t['shape']} is not finite")
    return t


def empty_card(torch, dev, what: str) -> None:
    """Free what Python no longer holds and check that under 1 GiB is left
    allocated before ``what`` is made."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    check(left < 2**30, f"{left / 2**30:.2f} GiB still allocated before {what}")


ROUTED_APART_MAX = 0.10     # 23(a): at most 10 % of the tokens route apart in bf16 and f32


def routed_apart(torch, want: list, got: list, n: int):
    """(n,) bool: which of the first ``n`` tokens some moe call of the run
    ``got`` sent to other experts than the same call of ``want`` (two
    ``models/moe.py`` recordings of the same prompt; all False when there is
    no moe layer)."""
    apart = torch.zeros(n, dtype=torch.bool)
    for x, y in zip(want, got, strict=True):
        apart |= (x["expert_id"][:n] != y["expert_id"][:n]).any(1).cpu()
    return apart


def serve_full_width(torch, dev, card: str, cfg, params, rng, init_s: float, tag: str) -> dict:
    """21(b) and 23(a)-(b): ``cfg`` (flash) with its weights ``params``
    through ActorServer (BIG_SERVE, BIG_REQUESTS requests of 1-512 prompt
    tokens): every request complete, finite prefill logits for every prompt
    and a finite decode step, the Hopper forward once a prefill per attention
    layer and no other flash kernel, flash against naive prefill logits on two
    prompts under 3e-2 relative l2, the rates, the peak memory and one
    profiled decode step of the slots.  A moe model's naive prefill routes
    as its flash prefill did (``moe.routed_as``), so that the distance is
    the attention's and not that of near-tied routes that rounding flips;
    the tokens that a free naive prefill routes apart are counted, and so
    are the tokens that the prefills dropped."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.models import moe as MOE
    from repro_torch.serve import ActorServeConfig, ActorServer, BucketSpec, DecodeEngine

    scfg = ActorServeConfig(**BIG_SERVE)
    spec = BucketSpec(scfg.buckets)
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    others = (fa.NAME, fa.DQ_NAME, fa.DKV_NAME, fa.DQ_SM90_NAME, fa.DKV_SM90_NAME)
    n_params = sum(p.numel() for p in params.parameters())
    weights = torch.cuda.memory_allocated(dev)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in [512, 1] + list(rng.randint(2, 513, size=BIG_REQUESTS - 2))]
    # a first server warms cuBLAS, the allocator and one prefill per bucket
    server = ActorServer(cfg, params, scfg, device=dev)
    warm = [server.submit(rng.randint(0, cfg.vocab_size, size=n).astype(np.int32), 2)
            for n in (100, 200, 400)]
    server.drain(timeout=900)
    check(all(len(h.result(0).tokens) == 2 for h in warm), f"{cfg.name}: the warm-up requests")
    del server, warm
    gc.collect()
    server = ActorServer(cfg, params, scfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    handles = [server.submit(p, scfg.max_new_tokens) for p in prompts]
    t0 = time.perf_counter()
    server.drain(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    st = server.stats()
    done = [h.result(0) for h in handles]
    per_prefill = backbone.flash_launches_per_prefill(cfg)
    check(all(len(c.tokens) == scfg.max_new_tokens for c in done)
          and st["generated_tokens"] == BIG_REQUESTS * scfg.max_new_tokens
          == st["admissions"] + st["decoded_tokens"],
          f"{cfg.name}: token accounting, stats {st}")
    check(all(0 <= t < cfg.vocab_size for c in done for t in c.tokens),
          f"{cfg.name}: token out of range")
    check(counts.get(fa.SM90_NAME) == per_prefill * st["admissions"]
          and st["admissions"] == BIG_REQUESTS and not any(counts.get(k) for k in others),
          f"{cfg.name}: flash launches {counts}, the code predicts {per_prefill} x "
          f"{st['admissions']} prefills of {fa.SM90_NAME} and no other flash kernel")
    del server
    gc.collect()
    # every prompt's prefill logits finite; flash against naive on two
    sums, sums_free, apart_n, compared = [0.0, 0.0], [0.0, 0.0], 0, 0
    drops = {"real": 0, "real_slots": 0, "all": 0, "all_slots": 0}
    k = cfg.experts_per_token
    for i, p in enumerate(prompts):
        with MOE.recording() as rf:
            lf, cache = prefill_logits(torch, backbone, cfg, params, p, spec, scfg.max_len, dev)
        check(bool(torch.isfinite(lf).all()), f"{cfg.name}: request {i}'s prefill logits")
        for r in rf:
            drops["real"] += int((~r["keep"][:len(p)]).sum())
            drops["all"] += int((~r["keep"]).sum())
            drops["real_slots"] += len(p) * k
            drops["all_slots"] += r["tokens"] * k
        if i < 2:
            with MOE.routed_as(rf):
                ln = prefill_logits(torch, backbone, naive_cfg, params, p, spec, scfg.max_len,
                                    dev)[0]
            check(bool(torch.isfinite(ln).all()), f"{cfg.name}: naive prefill logits")
            sums = [x + y for x, y in zip(sums, l2_sums(lf, ln))]
            compared += len(p)
            if rf:
                with MOE.recording() as rn:
                    ln = prefill_logits(torch, backbone, naive_cfg, params, p, spec,
                                        scfg.max_len, dev)[0]
                apart_n += int(routed_apart(torch, rf, rn, len(p)).sum())
                sums_free = [x + y for x, y in zip(sums_free, l2_sums(lf, ln))]
                del rn
            del ln
        if i == len(prompts) - 1:
            cache["pos"].fill_(len(p))
            tok = torch.argmax(lf[-1]).reshape(1, 1)
            lg = backbone.decode_step(cfg, params, cache, tok)[0]
            check(bool(torch.isfinite(lg).all()), f"{cfg.name}: decode logits not finite")
        del lf, cache, rf
    fn_rel = math.sqrt(sums[0] / sums[1])
    check(fn_rel < 3e-2, f"{cfg.name}: flash vs naive prefill logits differ by {fn_rel:.4g} "
          "relative l2")
    # one profiled decode step over the slots, each primed
    eng = DecodeEngine(cfg, slots=scfg.slots, max_len=scfg.max_len, buckets=spec, device=dev)
    state = eng.init_state()
    for slot, p in enumerate(prompts[:scfg.slots]):
        tok, slot_cache = eng.prime(params, p)
        state = eng.insert(state, slot, slot_cache, tok)
        del slot_cache
    _, state = eng.step(params, state)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state = eng.step(params, state)
        torch.cuda.synchronize()
        step_us = (time.perf_counter() - t0) * 1e6
    prof_d = profile_summary(torch, prof, step_us, 1)
    del eng, state, prof
    rate = {"params": n_params, "weights_bytes": weights, "init_s": init_s,
            "requests": BIG_REQUESTS, "new_tokens": scfg.max_new_tokens,
            "slots": scfg.slots, "buckets": list(scfg.buckets), "max_len": scfg.max_len,
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "first_tokens_per_s": st["admissions"] / st["prefill_s"],
            "decode_tokens_per_s": st["decoded_tokens"] / st["decode_s"],
            "latency_p50_ms": st["latency_p50_ms"], "latency_p99_ms": st["latency_p99_ms"],
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "decode_steps": st["steps"], "wall_s": wall, "peak_memory_bytes": peak,
            "flash_launches": counts.get(fa.SM90_NAME, 0), "launches": counts,
            "launches_per_prefill": per_prefill, "prefill_logits_rel_l2": fn_rel,
            "decode_step_profile": prof_d}
    moe_note = ""
    if cfg.family == "moe":
        free = math.sqrt(sums_free[0] / sums_free[1])
        rate.update(prefill_logits_rel_l2_free_routes=free, routed_apart=apart_n,
                    compared_tokens=compared, prefill_drops=drops)
        moe_note = (f", naive routed as flash (free: {free:.4g}, {apart_n} of {compared} "
                    f"tokens routed apart); the prefills dropped {drops['real']} of "
                    f"{drops['real_slots']} real token-slots and {drops['all']} of "
                    f"{drops['all_slots']} with the pad")
    print(f"[{tag}] {cfg.name} ({cfg.num_layers} layers, {n_params / 1e9:.3f} B params, bf16, "
          f"{weights / 2**30:.2f} GiB of weights, made in {init_s:.1f} s): {BIG_REQUESTS} "
          f"requests x {scfg.max_new_tokens} tokens on {scfg.slots} slots, "
          f"{rate['prompt_tokens']} prompt tokens: {rate['first_tokens_per_s']:.2f} "
          f"first-tokens/s, {rate['decode_tokens_per_s']:.1f} decode tokens/s, p50 "
          f"{rate['latency_p50_ms']:.0f} ms, p99 {rate['latency_p99_ms']:.0f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB; {fa.SM90_NAME} launches {rate['flash_launches']} = "
          f"{per_prefill} x {st['admissions']} prefills, no other flash kernel; prefill logits "
          f"flash vs naive rel l2 {fn_rel:.4g} on 2 prompts{moe_note}; one decode step of "
          f"{scfg.slots} slots: {step_us:,.0f} us wall, {prof_d['device_busy_us']:,.0f} us "
          f"device-busy, {prof_d['device_ops_per_step']:,.0f} device ops | {card}", flush=True)
    return rate


def big_dense_phase(torch, dev, card: str) -> dict:
    """Phase 21: each of BIG_DENSE, one at a time, on a card that holds
    nothing else (under 1 GiB allocated on entry): (a) at full width and
    EXACT_LAYERS layers, bf16 flash prefill logits against naive bf16 and
    both against the same weights in f32 (naive, TF32 off), phase 8's
    gates; (b) at full width and depth in bf16 with flash through
    ActorServer (BIG_SERVE, BIG_REQUESTS requests of 1-512 prompt tokens):
    every request complete, finite prefill logits for every prompt and a
    finite decode step, the Hopper forward once a prefill per attention
    layer and no other flash kernel, flash against naive prefill logits on
    two prompts under 3e-2 relative l2, the rates, the peak memory and one
    profiled decode step; (c) the Hopper forward at the model's prefill
    shape (heads, 512, 128) beside its bound and SDPA."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone
    from repro_torch.serve import ActorServeConfig, BucketSpec

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    scfg = ActorServeConfig(**BIG_SERVE)
    spec = BucketSpec(scfg.buckets)
    out = {}
    for arch, shape in BIG_DENSE:
        empty_card(torch, dev, arch)
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
               cfg.vocab_size, cfg.rope_theta, cfg.qkv_bias, cfg.norm, cfg.dtype)
              == (*shape, "bfloat16"), f"not {arch}'s configured shape: {cfg}")
        rng = np.random.RandomState(SEED + 21)
        res = {"model": cfg.name}

        # (a) full width, EXACT_LAYERS layers: flash and naive bf16 against f32
        cut = dataclasses.replace(cfg, num_layers=EXACT_LAYERS)
        cut_naive = dataclasses.replace(cut, attn_impl="naive")
        exact_cfg = dataclasses.replace(cut_naive, dtype="float32")
        params = backbone.init_params(cut, torch.Generator(device=dev).manual_seed(SEED))
        exact = backbone.Backbone(exact_cfg, dev)
        with torch.no_grad():
            for a, b in zip(exact.parameters(), params.parameters(), strict=True):
                a.copy_(b)
        lens = [1, 512] + [int(n) for n in rng.randint(2, 512, size=EXACT_PROMPTS - 2)]
        sums = {"fn": [0.0, 0.0], "fx": [0.0, 0.0], "nx": [0.0, 0.0]}
        for n in lens:
            p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
            lf = prefill_logits(torch, backbone, cut, params, p, spec, scfg.max_len, dev)[0]
            ln = prefill_logits(torch, backbone, cut_naive, params, p, spec, scfg.max_len, dev)[0]
            lx = prefill_logits(torch, backbone, exact_cfg, exact, p, spec, scfg.max_len, dev)[0]
            check(all(bool(torch.isfinite(x).all()) for x in (lf, ln, lx)),
                  f"{arch} {EXACT_LAYERS}-layer prefill logits not finite")
            for key, a, b in (("fn", lf, ln), ("fx", lf, lx), ("nx", ln, lx)):
                sums[key] = [x + y for x, y in zip(sums[key], l2_sums(a, b))]
            del lf, ln, lx
        del params, exact
        gc.collect()
        torch.cuda.empty_cache()
        rel = {key: math.sqrt(num / den) for key, (num, den) in sums.items()}
        check(rel["fx"] <= 1.1 * rel["nx"], f"{arch} at {EXACT_LAYERS} layers: flash prefill "
              f"logits are {rel['fx']:.4g} relative l2 from the f32 model, naive's "
              f"{rel['nx']:.4g}: flash adds error")
        check(rel["fn"] < 3e-2, f"{arch} at {EXACT_LAYERS} layers: flash vs naive prefill logits "
              f"differ by {rel['fn']:.4g} relative l2")
        res["exactness"] = {"layers": EXACT_LAYERS, "prompt_lens": lens,
                            "flash_vs_naive_rel_l2": rel["fn"], "flash_vs_f32_rel_l2": rel["fx"],
                            "naive_vs_f32_rel_l2": rel["nx"]}
        print(f"[big dense a] {cfg.name} at full width, {EXACT_LAYERS} layers, prompts of {lens} "
              f"tokens: prefill logits flash vs naive rel l2 {rel['fn']:.4g} (< 3e-2); from the "
              f"f32 model flash {rel['fx']:.4g}, naive {rel['nx']:.4g} (flash <= 1.1x naive) | "
              f"{card}", flush=True)

        # (b) full width and depth through ActorServer
        t0 = time.perf_counter()
        params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        res["serve"] = serve_full_width(torch, dev, card, cfg, params, rng,
                                        time.perf_counter() - t0, "big dense b")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the Hopper forward at this model's prefill shape: one prompt of
        # bucket 512, its KV heads expanded to the query heads
        t = flash_fwd_times(torch, dev, gen, cfg.num_heads, 512)
        res["flash_times"] = t
        print(f"[times] {fa.SM90_NAME} at {cfg.name}'s prefill {t['shape']}: device "
              f"{t['ms'] * 1e3:.1f} us (plain {t['plain_ms'] * 1e3:.1f} us, SDPA "
              f"{t['library_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.2f} us by "
              f"{t['bound_by']}, call {t['call_ms'] * 1e3:.1f} us) | {card}", flush=True)
        torch.cuda.empty_cache()
        out[arch] = res
    print(f"[big dense rate] {json.dumps(out)}", flush=True)
    return out


# -- phase 22: the ratio-scheduled token-DQN trainer ----------------------------

TRAINER_ARGS = ["--update-interval", "64", "--ckpt-every", "4", "--backend", "cuda"]
# 24 (--ckpt-every 12) until the hybrid and ssm phase (24), 16 (8) until the audio phase (25)
TRAINER_STEPS = 8


def token_trainer_phase(torch, dev, card: str) -> dict:
    """Phase 22: ``python -m repro_torch.train_token_dqn``'s main at its
    39.9 M-parameter config (f32, 32 actors x 64 tokens, replay 4,096 x
    K=128, batch 8), 8 collects at update interval 64: the printed
    schedule (every 2 collects, 1 update), 4 learn events with finite
    losses, the sample and gather kernels once a learn call, the update
    kernel twice an insert and once a priority write-back; the three
    kernels against their plain versions on the run's own tree and rows;
    then a second call that resumes from the last checkpoint."""
    import shutil
    import tempfile

    from repro_torch import train_token_dqn as ttd
    from repro_torch.core import sumtree
    from repro_torch.kernels import ops, parity

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_token_dqn_")
    argv = TRAINER_ARGS + ["--ckpt-dir", ckpt, "--seed", str(SEED)]
    try:
        printed = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            res = ttd.main(argv + ["--steps", str(TRAINER_STEPS)])
        counts = dict(ops.launch_counts)
        print(printed.getvalue(), end="", flush=True)
        learns, collects = res["learns"], TRAINER_STEPS
        check("ratio schedule: learn every 2 collect(s), 1 update(s) per event (64 segments per "
              "update)" in printed.getvalue() and (res["schedule"].period, res["schedule"].learns)
              == (2, 1), f"the trainer's schedule: {res['schedule']}")
        check(len(learns) == TRAINER_STEPS // 2 and all(math.isfinite(e[k]) for e in learns
                                        for k in ("loss", "grad_norm", "q_mean")),
              f"{len(learns)} learn events, losses {[e['loss'] for e in learns]}")
        want = {"sumtree_sample": len(learns), "gather": len(learns),
                "sumtree_update": 2 * collects + len(learns)}
        check(all(counts.get(k) == v for k, v in want.items())
              and not counts.get("sample_gather"), f"the trainer launched {counts}, the code "
              f"predicts {want} (two update launches an eager insert, one a write-back)")
        check(res["checkpoints"] == [TRAINER_STEPS // 2, TRAINER_STEPS],
              f"checkpoints {res['checkpoints']}")
        # the kernels against their plain versions at the trainer's shapes:
        # the sample and gather on its tree and 64-token rows; the tree its
        # eager writes left against the plain rebuild of the same leaves;
        # then one more insert (32 fresh slots at P_max) and one write-back
        # (8 sampled rows, repeats kept) through the kernel and through the
        # plain update, each from the run's tree
        replay, rst = res["replay"], res["replay_state"]
        spec, tree = replay.spec, rst.tree
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        ties = replay_parity(torch, replay, rst, gen, "the token-DQN trainer")
        problems = parity.tree_mismatch(spec, tree, sumtree.rebuild(spec, tree.clone()))
        check(not problems, f"the trainer's eagerly written tree against the plain rebuild of "
              f"its leaves: {problems}")
        n_envs = ttd.parse_args(argv).n_envs
        slots = (rst.head + torch.arange(n_envs, device=dev)) % spec.capacity
        back, _ = ops.sumtree_sample(spec, tree, torch.rand((8,), generator=gen, device=dev))
        writes = {"insert": (slots, rst.max_priority.expand(n_envs), True),
                  "write-back": (back, torch.rand((8,), generator=gen, device=dev) * 3, False)}
        update_err = 0.0
        for what, (idx, val, unique) in writes.items():
            got = ops.sumtree_update(spec, tree.clone(), idx, val, unique=unique)
            plain = sumtree.update(spec, tree.clone(), idx, val, unique=unique)
            torch.cuda.synchronize()
            problems = parity.tree_mismatch(spec, got, plain)
            check(not problems, f"sumtree_update of the trainer's {what} ({idx.numel()} rows): "
                  f"{problems}")
            update_err = max(update_err, float((got - plain).abs().max()))
        print(f"[token-dqn parity] the trainer's tree after {want['sumtree_update']} "
              f"eager update launches agrees with the plain rebuild of its leaves; "
              f"sumtree_update of a {n_envs}-row insert and an 8-row write-back ({back.unique().numel()} distinct) "
              f"on it agrees with the plain update (leaves bit for bit, max |err| "
              f"{update_err:.3g}) | {card}", flush=True)
        del replay, rst, tree, got, plain
        peak, secs = res["peak_memory_bytes"], res["seconds"]
        n_params = sum(p.numel() for p in res["state"].params.parameters())
        rewards = res["rewards"]
        del res
        printed = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            again = ttd.main(argv + ["--steps", str(TRAINER_STEPS + 2)])
        resume_counts = dict(ops.launch_counts)
        print(printed.getvalue(), end="", flush=True)
        check(f"resumed from checkpoint step {TRAINER_STEPS}" in printed.getvalue()
              and again["start"] == TRAINER_STEPS
              and [e["it"] for e in again["learns"]] == [TRAINER_STEPS]
              and resume_counts.get("sumtree_sample") == 1,
              f"the second call: start {again['start']}, learns {again['learns']}, launches "
              f"{resume_counts}")
        del again
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out = {"params": n_params, "collects": collects, "learns": len(learns),
           "losses": [e["loss"] for e in learns], "rewards": rewards, "seconds": secs,
           "peak_memory_bytes": peak, "launches": counts, "resume_launches": resume_counts,
           "sample_flips_at_65536": ties.flips, "update_max_abs_err": update_err}
    print(f"[token-dqn] train_token_dqn --steps {TRAINER_STEPS} {' '.join(TRAINER_ARGS)}: "
          f"{n_params / 1e6:.1f} M params, "
          f"{collects} collects of 32 x 64 tokens and {len(learns)} learn calls in {secs:.1f} s, "
          f"losses {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; launches {counts}; peak "
          f"memory {peak / 2**30:.2f} GiB; resumed from {TRAINER_STEPS} with {resume_counts} | "
          f"{card}",
          flush=True)
    return out


# -- phase 23: the moe and vlm families at full width -------------------------------

# (arch, layers served, its published shape: layers, d_model, heads, KV heads, hd, d_ff,
# vocab, experts, top-k, shared experts, attention, window, global period)
MOE_SERVE = (("mixtral_8x7b", 24,
              (32, 4096, 32, 8, 128, 14336, 32000, 8, 2, 0, "sliding", 4096, 0)),
             ("llama4_maverick_400b_a17b", 4,
              (48, 5120, 40, 8, 128, 8192, 202048, 128, 1, 1, "chunked", 8192, 4)))
MOE_CUT = {"mixtral_8x7b": "32 layers are 87.0 GiB of bf16 weights, past the card's 80 GB; "
                           "24 are 65.4 GiB, under phase 21's Qwen1.5-32B",
           "llama4_maverick_400b_a17b": "a unit (attn, mlp, attn, moe) is 30.6 GiB with its 128 "
                                        "experts; 2 units (layers 0-3, global layer 3) are 65.0 "
                                        "GiB with the 3.9 GiB of embeddings"}
MOE_PEAK_LIMIT = 74 * 2**30      # 23(a)-(b): phase 21's Qwen1.5-32B peaked at 73.9 GiB
MIXTRAL_EXACT = (2, 4608)        # 23(a): layers, prompt tokens (36 x 128, past the 4,096 window)
DECODE_RULE_SLOTS = 16           # 23(d): 12 slots on one prompt, 4 on others
DECODE_RULE_BOUND = 1e-2         # 23(d): a slot's logits against its batch-1 call, relative l2
PHI_PROMPTS, PHI_TEXT, PHI_STEPS = 4, 64, 16   # 23(c)


def moe_exactness(torch, dev, card: str, cfg) -> dict:
    """23(a)'s check: Mixtral at full width and MIXTRAL_EXACT's layers on one
    prompt past the sliding window, through ``backbone.prefill`` outside the
    engine: bf16 flash, bf16 naive and the same weights in f32 (naive, TF32
    off).  Free, the bf16 runs route some tokens to other experts than the
    f32 run (counted; at most ROUTED_APART_MAX of them); routed as the f32
    run (``moe.routed_as``), phase 21's rule over every token: flash no
    farther from f32 than 1.1x naive, flash vs naive under 3e-2 relative
    l2."""
    import gc

    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    from repro_torch.models import moe as MOE

    layers, n = MIXTRAL_EXACT
    cut = dataclasses.replace(cfg, num_layers=layers)
    cut_naive = dataclasses.replace(cut, attn_impl="naive")
    exact_cfg = dataclasses.replace(cut_naive, dtype="float32")
    params = backbone.init_params(cut, torch.Generator(device=dev).manual_seed(SEED))
    exact = backbone.Backbone(exact_cfg, dev)
    with torch.no_grad():
        for a, b in zip(exact.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    rng = np.random.RandomState(SEED + 23)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(1, n))).to(dev).long()

    def run(c, p, routes=None):
        ops.reset_launch_counts()
        with MOE.recording() as rec, (MOE.routed_as(routes) if routes is not None
                                      else contextlib.nullcontext()):
            logits = backbone.prefill(c, p, tokens, n)[0][0].float()
        check(bool(torch.isfinite(logits).all()), f"{c.name} {c.attn_impl} {c.dtype} prefill "
              "logits not finite")
        launches = ops.launch_counts[fa.SM90_NAME]
        check(launches == (layers if c.attn_impl == "flash" else 0),
              f"{c.name} {c.attn_impl} prefill: {launches} launches of {fa.SM90_NAME}")
        return logits, rec

    lx, rx = run(exact_cfg, exact)
    free = {key: run(c, params) for key, c in (("flash", cut), ("naive", cut_naive))}
    apart = {key: int(routed_apart(torch, rx, rec, n).sum()) for key, (_, rec) in free.items()}
    free_rel = {key: rel_l2([(lg, lx)]) for key, (lg, _) in free.items()}
    del free
    lf, ln = run(cut, params, rx)[0], run(cut_naive, params, rx)[0]
    del params, exact
    gc.collect()
    torch.cuda.empty_cache()
    rel = {key: rel_l2([(a, b)]) for key, a, b in (("fn", lf, ln), ("fx", lf, lx),
                                                   ("nx", ln, lx))}
    check(max(apart.values()) <= ROUTED_APART_MAX * n, f"{cfg.name}: of {n} tokens, {apart} "
          "routed to other experts in bf16 than in f32")
    check(rel["fx"] <= 1.1 * rel["nx"], f"{cfg.name} at {layers} layers, routed as f32: flash "
          f"prefill logits are {rel['fx']:.4g} relative l2 from the f32 model, naive's "
          f"{rel['nx']:.4g}: flash adds error")
    check(rel["fn"] < 3e-2, f"{cfg.name} at {layers} layers, routed as f32: flash vs naive "
          f"prefill logits differ by {rel['fn']:.4g} relative l2")
    out = {"layers": layers, "prompt_tokens": n, "routed_apart_from_f32": apart,
           "free_routes_rel_l2_from_f32": free_rel, "flash_vs_naive_rel_l2": rel["fn"],
           "flash_vs_f32_rel_l2": rel["fx"], "naive_vs_f32_rel_l2": rel["nx"]}
    print(f"[moe a] {cfg.name} at full width, {layers} layers, one prompt of {n} tokens (past the "
          f"{cfg.window} window): {apart['flash']} tokens routed to other experts in bf16 flash "
          f"than in f32, {apart['naive']} in bf16 naive (at most {ROUTED_APART_MAX:.0%}), their "
          f"logits {free_rel['flash']:.4g} and {free_rel['naive']:.4g} from f32; routed as f32: "
          f"prefill logits flash vs naive rel l2 {rel['fn']:.4g} (< 3e-2), from the f32 model "
          f"flash {rel['fx']:.4g}, naive {rel['nx']:.4g} (flash <= 1.1x naive) | {card}",
          flush=True)
    return out


def moe_decode_rule(torch, dev, card: str, cfg, params) -> dict:
    """23(d): DECODE_RULE_SLOTS slots, 12 of them primed with one prompt, so
    that more of them pick one expert in a decode step than the capacity of a
    call over the slots; the batched step (which drops no token) against
    each slot's own batch-1 call (whose capacity no token can exceed): the
    same experts on every slot and logits under DECODE_RULE_BOUND relative
    l2; and the tokens that a capacity-limited batched step would have
    dropped."""
    import numpy as np

    from repro_torch.models import backbone
    from repro_torch.models import moe as MOE
    from repro_torch.serve import BucketSpec, DecodeEngine

    slots = DECODE_RULE_SLOTS
    eng = DecodeEngine(cfg, slots=slots, max_len=BIG_SERVE["max_len"],
                       buckets=BucketSpec(BIG_SERVE["buckets"]), device=dev)
    rng = np.random.RandomState(SEED + 24)
    same = rng.randint(0, cfg.vocab_size, size=100).astype(np.int32)
    batch = [same] * 12 + [rng.randint(0, cfg.vocab_size, size=int(m)).astype(np.int32)
                           for m in rng.randint(2, 513, size=slots - 12)]
    state = eng.init_state()
    for slot, p in enumerate(batch):
        tok, slot_cache = eng.prime(params, p)
        state = eng.insert(state, slot, slot_cache, tok)
        del slot_cache
    singles = [{"pos": state.cache["pos"][s:s + 1].clone(),
                "k": state.cache["k"][:, s:s + 1].clone(),
                "v": state.cache["v"][:, s:s + 1].clone()} for s in range(slots)]
    tokens = state.tokens.clone()
    with MOE.recording() as rb:
        batched = backbone.decode_step(cfg, params, state.cache, tokens)[0][:, 0].float()
    check(bool(torch.isfinite(batched).all()), f"{cfg.name}: batched decode logits not finite")
    cap = MOE.capacity(cfg, slots)
    top = max(int(torch.bincount(r["expert_id"][:, 0]).max()) for r in rb)
    capped = sum(MOE.dropped_if_capped(cfg, r["expert_id"]) for r in rb)
    check(top > cap and capped > 0 and all(bool(r["keep"].all()) for r in rb),
          f"{cfg.name}: the batched step's busiest expert took {top} of {slots} slots against a "
          f"capacity of {cap}; {capped} would drop; every token kept: "
          f"{[bool(r['keep'].all()) for r in rb]}")
    rels, apart, same_tok = [], 0, 0
    for s in range(slots):
        with MOE.recording() as r1:
            one = backbone.decode_step(cfg, params, singles[s], tokens[s:s + 1])[0][0, 0].float()
        row = [{"expert_id": r["expert_id"][s:s + 1]} for r in rb]
        apart += int(routed_apart(torch, r1, row, 1).sum())
        rels.append(rel_l2([(batched[s], one)]))
        same_tok += int(torch.argmax(batched[s]) == torch.argmax(one))
    check(apart == 0 and max(rels) <= DECODE_RULE_BOUND,
          f"{cfg.name}: batched decode against batch-1 calls: {apart} slots routed apart, rel "
          f"l2 up to {max(rels):.4g} (bound {DECODE_RULE_BOUND})")
    out = {"slots": slots, "busiest_expert_slots": top, "capacity_of_a_call": cap,
           "dropped_if_capped": capped, "max_rel_l2": max(rels), "greedy_equal": same_tok}
    print(f"[moe d] {cfg.name}: one batched decode step over {slots} slots (12 on one prompt): "
          f"the busiest expert took {top} slots, a capacity-limited step over the slots "
          f"(capacity {cap}) would have dropped {capped} tokens, this one dropped none; against "
          f"each slot's batch-1 call: the same experts on every slot, logits rel l2 at most "
          f"{max(rels):.4g} (bound {DECODE_RULE_BOUND}), greedy token equal on {same_tok} | "
          f"{card}", flush=True)
    return out


def phi_vision(torch, dev, card: str) -> dict:
    """23(c): Phi-3-vision at full width and depth, bf16 with flash:
    PHI_PROMPTS prompts of 576 patch embeddings (from the seed, x 0.1) and
    PHI_TEXT text tokens prefilled at S = 640 (one Hopper forward a layer,
    no other flash kernel), then PHI_STEPS greedy decode steps (pos = 640 +
    steps on every row); the prefill logits of flash and naive bf16 against
    the same weights in f32 (naive, TF32 off): flash no farther than 1.1x
    naive, flash vs naive under 3e-2 relative l2."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import backbone

    empty_card(torch, dev, "Phi-3-vision")
    cfg = dataclasses.replace(get_config("phi_3_vision_4_2b"), attn_impl="flash")
    check((cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab_size, cfg.num_patch_tokens, cfg.dtype)
          == ("vlm", 32, 3072, 32, 32, 96, 8192, 32064, 576, "bfloat16"),
          f"not Phi-3-vision's configured shape: {cfg}")
    naive_cfg = dataclasses.replace(cfg, attn_impl="naive")
    exact_cfg = dataclasses.replace(naive_cfg, dtype="float32")
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev)
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.RandomState(SEED + 23)
    patches = torch.from_numpy((rng.standard_normal(
        (PHI_PROMPTS, cfg.num_patch_tokens, cfg.d_model)) * 0.1).astype(np.float32)).to(dev)
    text = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(PHI_PROMPTS, PHI_TEXT))
                            ).to(dev).long()
    s = cfg.num_patch_tokens + PHI_TEXT
    max_len = s + PHI_STEPS
    backbone.prefill(cfg, params, text, max_len, patches)        # warm cuBLAS and the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = backbone.prefill(cfg, params, text, max_len, patches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    others = (fa.NAME, fa.DQ_NAME, fa.DKV_NAME, fa.DQ_SM90_NAME, fa.DKV_SM90_NAME)
    check(counts.get(fa.SM90_NAME) == backbone.flash_launches_per_prefill(cfg) == cfg.num_layers
          and not any(counts.get(k) for k in others),
          f"Phi-3-vision prefill: flash launches {counts}, the code predicts {cfg.num_layers} of "
          f"{fa.SM90_NAME} and no other flash kernel")
    check(tuple(logits.shape) == (PHI_PROMPTS, s, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"Phi-3-vision prefill logits {logits.shape}")
    lf = logits.float()
    tok = torch.argmax(lf[:, -1], dim=-1)
    decoded = [tok]
    t0 = time.perf_counter()
    for _ in range(PHI_STEPS):
        lg, cache = backbone.decode_step(cfg, params, cache, tok[:, None])
        check(bool(torch.isfinite(lg).all()), "Phi-3-vision decode logits not finite")
        tok = torch.argmax(lg[:, -1], dim=-1)
        decoded.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(cache["pos"].tolist() == [s + PHI_STEPS] * PHI_PROMPTS,
          f"Phi-3-vision pos after {PHI_STEPS} steps: {cache['pos'].tolist()}")
    del cache, logits
    ln = backbone.prefill(naive_cfg, params, text, max_len, patches)[0].float()
    exact = backbone.Backbone(exact_cfg, dev)
    with torch.no_grad():
        for a, b in zip(exact.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    del params
    gc.collect()
    lx = backbone.prefill(exact_cfg, exact, text, max_len, patches)[0]
    del exact
    check(bool(torch.isfinite(ln).all()) and bool(torch.isfinite(lx).all()),
          "Phi-3-vision naive or f32 prefill logits not finite")
    rel = {key: rel_l2([(a, b)]) for key, a, b in (("fn", lf, ln), ("fx", lf, lx), ("nx", ln, lx))}
    first_equal = int((torch.argmax(lf[:, -1], -1) == torch.argmax(lx[:, -1], -1)).sum())
    del lf, ln, lx
    gc.collect()
    torch.cuda.empty_cache()
    check(rel["fx"] <= 1.1 * rel["nx"], f"Phi-3-vision: flash prefill logits are "
          f"{rel['fx']:.4g} relative l2 from the f32 model, naive's {rel['nx']:.4g}: flash adds "
          "error")
    check(rel["fn"] < 3e-2, f"Phi-3-vision: flash vs naive prefill logits differ by "
          f"{rel['fn']:.4g} relative l2")
    out = {"model": cfg.name, "params": n_params, "weights_bytes": weights, "init_s": init_s,
           "prompts": PHI_PROMPTS, "patches": cfg.num_patch_tokens, "text_tokens": PHI_TEXT,
           "decode_steps": PHI_STEPS, "prefill_s": prefill_s, "decode_s": decode_s,
           "prefill_tokens_per_s": PHI_PROMPTS * s / prefill_s,
           "decode_tokens_per_s": PHI_PROMPTS * PHI_STEPS / decode_s,
           "peak_memory_bytes": peak, "launches": counts, "flash_vs_naive_rel_l2": rel["fn"],
           "flash_vs_f32_rel_l2": rel["fx"], "naive_vs_f32_rel_l2": rel["nx"],
           "first_token_equal_to_f32": first_equal}
    print(f"[vlm c] {cfg.name} at full width and depth ({n_params / 1e9:.3f} B params, bf16, "
          f"{weights / 2**30:.2f} GiB of weights, made in {init_s:.1f} s): {PHI_PROMPTS} prompts "
          f"of {cfg.num_patch_tokens} patches + {PHI_TEXT} tokens prefilled in "
          f"{prefill_s * 1e3:.1f} ms ({out['prefill_tokens_per_s']:,.0f} tokens/s), {PHI_STEPS} "
          f"greedy decode steps in {decode_s * 1e3:.1f} ms ({out['decode_tokens_per_s']:.1f} "
          f"tokens/s), pos {s + PHI_STEPS} on every row; peak memory {peak / 2**30:.2f} GiB; "
          f"{fa.SM90_NAME} launches {counts.get(fa.SM90_NAME)} a prefill, no other flash kernel; "
          f"prefill logits flash vs naive rel l2 {rel['fn']:.4g} (< 3e-2), from the f32 model "
          f"flash {rel['fx']:.4g}, naive {rel['nx']:.4g} (flash <= 1.1x naive); first greedy "
          f"token equal to f32's on {first_equal} of {PHI_PROMPTS} | {card}", flush=True)
    return out


def moe_vlm_phase(torch, dev, card: str) -> dict:
    """Phase 23: each of MOE_SERVE at full width and its served layers (the
    count and the reason printed; peak at most MOE_PEAK_LIMIT), one at a
    time on a card that holds nothing else, served through ActorServer as
    phase 21(b) (``serve_full_width``); Mixtral's exactness check past its
    window (``moe_exactness``), Llama-4's batched-decode rule
    (``moe_decode_rule``); Phi-3-vision with its patch prefix
    (``phi_vision``); then the Hopper forward at the new shapes, each held to
    its plain version first, beside its bound and SDPA with the same mask."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import backbone

    out = {"moe": {}}
    for arch, layers, shape in MOE_SERVE:
        empty_card(torch, dev, arch)
        full = get_config(arch)
        check((full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.hd,
               full.d_ff, full.vocab_size, full.num_experts, full.experts_per_token,
               full.num_shared_experts, full.attention, full.window, full.global_layer_period,
               full.dtype) == (*shape, "bfloat16"), f"not {arch}'s configured shape: {full}")
        cfg = dataclasses.replace(full, attn_impl="flash", num_layers=layers)
        print(f"[moe] {cfg.name}: {layers} of {full.num_layers} layers at full width: "
              f"{MOE_CUT[arch]} | {card}", flush=True)
        res = {"model": cfg.name, "layers": layers, "of_layers": full.num_layers,
               "cut": MOE_CUT[arch]}
        if arch == "mixtral_8x7b":
            res["exactness"] = moe_exactness(torch, dev, card, cfg)
            empty_card(torch, dev, f"{arch} at {layers} layers")
        t0 = time.perf_counter()
        params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        rng = np.random.RandomState(SEED + 23)
        res["serve"] = serve_full_width(torch, dev, card, cfg, params, rng,
                                        time.perf_counter() - t0, "moe b")
        peak = res["serve"]["peak_memory_bytes"]
        check(peak <= MOE_PEAK_LIMIT, f"{cfg.name} at {layers} layers peaked at "
              f"{peak / 2**30:.2f} GiB, over {MOE_PEAK_LIMIT / 2**30:.0f}")
        if arch == "llama4_maverick_400b_a17b":
            res["decode_rule"] = moe_decode_rule(torch, dev, card, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["moe"][arch] = res
    out["vlm"] = phi_vision(torch, dev, card)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    out["flash_times"] = {}
    for what, args in (("Mixtral's exactness prefill", (32, 4608, 128, "sliding", 4096, False)),
                       ("Llama-4's prefill, a local layer", (40, 512, 128, "chunked", 8192, False)),
                       ("Llama-4's prefill, the global layer", (40, 512, 128, "chunked", 8192,
                                                                True)),
                       ("Phi-3-vision's prefill, one prompt", (32, 640, 96, "full", 0, True))):
        t = flash_fwd_times(torch, dev, gen, *args, parity=True)
        out["flash_times"][what] = t
        print(f"[times] {fa.SM90_NAME} at {what} {t['shape']} ({t['pairs']:,} pairs), against "
              f"its plain version max |err| {t['max_abs_err']:.3g}: device {t['ms'] * 1e3:.1f} us "
              f"(plain {t['plain_ms'] * 1e3:.1f} us, SDPA {t['library_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, call {t['call_ms'] * 1e3:.1f} us)"
              f" | {card}", flush=True)
        torch.cuda.empty_cache()
    print(f"[moe vlm rate] {json.dumps(out)}", flush=True)
    return out


# -- phase 24: the hybrid and ssm families at full width -----------------------------

# its published shape: family, layers, d_model, heads, KV heads, hd, d_ff, vocab, attention,
# window, global layers, SSM state, dtype
HYMBA_SHAPE = ("hybrid", 32, 1600, 25, 5, 64, 5504, 32001, "sliding", 1024, (0, 15, 31), 16,
               "bfloat16")
# family, blocks, d_model, heads, vocab, sLSTM blocks, tied embeddings, dtype
XLSTM_SHAPE = ("ssm", 12, 768, 4, 50304, (1, 7), True, "bfloat16")
# family, decoder and encoder layers, frames, d_model, heads, KV heads, hd, d_ff, vocab, norm,
# act, tied embeddings, dtype
WHISPER_SHAPE = ("audio", 24, 24, 1500, 1024, 16, 16, 64, 4096, 51865, "layernorm", "gelu", True,
                 "bfloat16")
SHAPES = {"hymba_1_5b": HYMBA_SHAPE, "xlstm_125m": XLSTM_SHAPE, "whisper_medium": WHISPER_SHAPE}
WHISPER_PARAMS = 960_865_280     # the reference's init_params, counted with jax.eval_shape
# 24(a), 24(c), 25(a): prompts x tokens (Whisper's each behind its 1,500 frames)
DECODE_PROMPTS = {"hymba_1_5b": (4, 2048), "xlstm_125m": (4, 256), "whisper_medium": (4, 128)}
DECODE_STEPS = 16
# 24(a), 24(c): decode step t's logits against the forward's over the prompt and the t
# tokens fed, relative l2 over every prompt and step: in f32 at most DECODE_F32_BOUND; in
# bf16 the decode no farther from the f32 forward than DECODE_BF16_RATIO x the bf16
# forward is.  These families' bf16 arm lies far from its f32 arm in the reference too
# (tests/test_torch_models.py::test_bf16_rounding_as_the_references), so the bf16 rules
# are relative (phase 21's flash <= 1.1x naive for Hymba); xLSTM, which has no flash arm,
# holds its bf16 prefill logits within XLSTM_BF16_BOUND of the f32 model's
DECODE_F32_BOUND = 1e-3
DECODE_BF16_RATIO = 1.5
XLSTM_BF16_BOUND = 0.25
# 24(b), 24(c): 16 actors, batch 8; segments of 128 tokens (Hymba's, the shortest its
# flash path takes) and 64 (xLSTM's), since a collect is that many host-bound forwards:
# at 256 tokens one took 26-36 s for Hymba and 8-15 s for xLSTM, whose Python-loop train
# step took 7.8 s; the script has to end inside 1,200 s
RECURRENT_SEQ = {"hymba_1_5b": 128, "xlstm_125m": 64}
# one step each (two until the audio phase (25) needed the time)
RECURRENT_TRAIN_STEPS = 1
RECURRENT_TRAIN = ["--batch", "8", "--n-envs", "16", "--steps", str(RECURRENT_TRAIN_STEPS),
                   "--ckpt-every", "0"]


def decode_against_forward(torch, backbone, cfg, params, prompts, dev, feed=None,
                           extra=None) -> dict:
    """Prefill ``prompts`` (B, S) (behind Whisper's frames ``extra``),
    decode DECODE_STEPS steps (greedy, or
    the tokens ``feed`` (B, steps), so that two models run the same
    sequences), and hold each step's logits against ``forward`` over the
    prompt and the tokens fed so far (one forward over the prompt, the fed tokens and a
    filler up to a multiple of 128, which a causal model's earlier positions
    do not see, so that the SSM's chunk rule holds).  → {"prefill_logits",
    "decode_logits" (B, steps, V) and the forward's "forward_logits" at the
    same positions (all f32), "fed" tokens (B, steps), "decode_rel_l2",
    "prefill_s", "decode_s", "pos", "forward_tokens"}."""
    b, s = prompts.shape
    steps = DECODE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = backbone.prefill(cfg, params, prompts, s + steps, extra)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    lp = logits.float()
    del logits
    tok = torch.argmax(lp[:, -1], dim=-1) if feed is None else feed[:, 0]
    fed, dec = [], []
    t0 = time.perf_counter()
    for t in range(steps):
        fed.append(tok)
        lg, cache = backbone.decode_step(cfg, params, cache, tok[:, None])
        dec.append(lg[:, 0].float())
        tok = (torch.argmax(lg[:, 0], dim=-1) if feed is None
               else feed[:, min(t + 1, steps - 1)])
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    pos = cache["pos"].tolist()
    del cache
    fed = torch.stack(fed, dim=1)
    total = s + steps
    if cfg.family == "hybrid" and total > 128:
        total = -(-total // 128) * 128
    seq = torch.cat([prompts, fed, torch.zeros((b, total - s - steps), dtype=prompts.dtype,
                                               device=dev)], dim=1)
    with torch.no_grad():
        lf = backbone.forward(cfg, params, seq, extra)[:, s:s + steps].float()
    dec = torch.stack(dec, dim=1)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(lf).all())
          and bool(torch.isfinite(lp).all()), f"{cfg.name} {cfg.dtype}: logits not finite")
    return {"prefill_logits": lp, "decode_logits": dec, "forward_logits": lf, "fed": fed,
            "decode_rel_l2": rel_l2([(dec, lf)]), "prefill_s": prefill_s,
            "decode_s": decode_s, "pos": pos, "forward_tokens": total}


def f32_copy(torch, backbone, cfg, params, dev):
    """The same weights in f32, naive attention."""
    exact_cfg = dataclasses.replace(cfg, attn_impl="naive", dtype="float32")
    exact = backbone.Backbone(exact_cfg, dev)
    with torch.no_grad():
        for a, b in zip(exact.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    return exact_cfg, exact


def model_shape(cfg) -> tuple:
    """The fields of ``cfg`` that SHAPES pins, by family."""
    if cfg.family == "hybrid":
        return (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.attention, cfg.window,
                cfg.global_layers, cfg.ssm_state, cfg.dtype)
    if cfg.family == "ssm":
        return (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size,
                cfg.slstm_at, cfg.tie_embeddings, cfg.dtype)
    return (cfg.family, cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq, cfg.d_model,
            cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.norm,
            cfg.act, cfg.tie_embeddings, cfg.dtype)


def prefill_and_decode(torch, dev, card: str, arch: str) -> dict:
    """24(a), 24(c) and 25(a): ``arch`` at full width and depth in bf16
    (Hymba and Whisper with flash), DECODE_PROMPTS prompts prefilled (Whisper's
    each behind 1,500 frames drawn from the seed, bf16-representable, so that
    the f32 copy reads the same) and DECODE_STEPS greedy decode steps: the
    flash launches the code predicts a prefill and no other flash kernel,
    ``pos`` after the steps, decode against forward in f32
    (DECODE_F32_BOUND) and in bf16 (DECODE_BF16_RATIO); Hymba's and Whisper's
    prefill logits under phase 21's rule (flash no farther from the f32 model
    than 1.1x naive bf16; flash vs naive reported), xLSTM's bf16 logits within
    XLSTM_BF16_BOUND of f32; the first greedy token against f32's, the peak
    memory, prefill (tokens and frames apart) and decode tokens/s."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import backbone

    empty_card(torch, dev, arch)
    cfg = get_config(arch)
    flash = cfg.family in ("hybrid", "audio")
    if flash:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    check(model_shape(cfg) == SHAPES[arch], f"not {cfg.name}'s configured shape: {cfg}")
    n, s = DECODE_PROMPTS[arch]
    t0 = time.perf_counter()
    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev)
    n_params = sum(p.numel() for p in params.parameters())
    check(cfg.family != "audio" or n_params == WHISPER_PARAMS,
          f"{cfg.name}: {n_params:,} params, the reference builds {WHISPER_PARAMS:,}")
    rng = np.random.RandomState(SEED + 24)
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(n, s))).to(dev).long()
    frames = None
    if cfg.family == "audio":
        frames = (torch.randn((n, cfg.encoder_seq, cfg.d_model), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 25))
                  * 0.1).to(torch.bfloat16).float()
    backbone.prefill(cfg, params, prompts, s, frames)      # warm cuBLAS and the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    backbone.prefill(cfg, params, prompts, s, frames)
    counts = dict(ops.launch_counts)
    per_prefill = backbone.flash_launches_per_prefill(cfg)
    others = (fa.NAME, fa.DQ_NAME, fa.DKV_NAME, fa.DQ_SM90_NAME, fa.DKV_SM90_NAME)
    check(counts.get(fa.SM90_NAME, 0) == per_prefill
          == (cfg.num_layers if flash else 0)
          and not any(counts.get(k) for k in others),
          f"{cfg.name} prefill: flash launches {counts}, the code predicts {per_prefill} of "
          f"{fa.SM90_NAME} and no other flash kernel")
    run = decode_against_forward(torch, backbone, cfg, params, prompts, dev, extra=frames)
    peak = torch.cuda.max_memory_allocated(dev)
    check(run["pos"] == [s + DECODE_STEPS] * n, f"{cfg.name} pos after the steps: "
          f"{run['pos']}")
    lf = run.pop("prefill_logits")
    ln = None
    if flash:
        ln = backbone.prefill(dataclasses.replace(cfg, attn_impl="naive"), params, prompts,
                              s, frames)[0].float()
    exact_cfg, exact = f32_copy(torch, backbone, cfg, params, dev)
    del params
    gc.collect()
    xrun = decode_against_forward(torch, backbone, exact_cfg, exact, prompts, dev, run["fed"],
                                  frames)
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    lx = xrun.pop("prefill_logits")
    check(xrun["decode_rel_l2"] <= DECODE_F32_BOUND, f"{cfg.name} f32: decode logits "
          f"{xrun['decode_rel_l2']:.4g} relative l2 from the forward's (bound "
          f"{DECODE_F32_BOUND})")
    # bf16: the decode and the forward each against the f32 forward
    dec_x = rel_l2([(run.pop("decode_logits"), xrun["forward_logits"])])
    fwd_x = rel_l2([(run.pop("forward_logits"), xrun.pop("forward_logits"))])
    del xrun["decode_logits"]
    check(dec_x <= DECODE_BF16_RATIO * fwd_x, f"{cfg.name} bf16: decode logits {dec_x:.4g} "
          f"relative l2 from the f32 forward's, the bf16 forward's {fwd_x:.4g}: decode adds "
          f"error (bound {DECODE_BF16_RATIO}x)")
    first_equal = int((torch.argmax(lf[:, -1], -1) == torch.argmax(lx[:, -1], -1)).sum())
    out = {"model": cfg.name, "params": n_params, "weights_bytes": weights, "init_s": init_s,
           "prompts": n, "prompt_tokens": s, "decode_steps": DECODE_STEPS,
           "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
           "prefill_tokens_per_s": n * s / run["prefill_s"],
           "prefill_frames_per_s": n * cfg.encoder_seq / run["prefill_s"] if frames is not None
           else None,
           "decode_tokens_per_s": n * DECODE_STEPS / run["decode_s"],
           "peak_memory_bytes": peak, "launches": counts, "launches_per_prefill": per_prefill,
           "decode_vs_forward_rel_l2": run["decode_rel_l2"],
           "decode_vs_forward_rel_l2_f32": xrun["decode_rel_l2"],
           "decode_vs_f32_forward_rel_l2": dec_x, "forward_vs_f32_forward_rel_l2": fwd_x,
           "forward_tokens": run["forward_tokens"], "first_token_equal_to_f32": first_equal}
    if ln is not None:
        rel = {key: rel_l2([(a, b)]) for key, a, b in (("fn", lf, ln), ("fx", lf, lx),
                                                       ("nx", ln, lx))}
        check(rel["fx"] <= 1.1 * rel["nx"], f"{cfg.name}: flash prefill logits are "
              f"{rel['fx']:.4g} relative l2 from the f32 model, naive's {rel['nx']:.4g}: flash "
              "adds error")
        out.update(flash_vs_naive_rel_l2=rel["fn"], flash_vs_f32_rel_l2=rel["fx"],
                   naive_vs_f32_rel_l2=rel["nx"])
        exact_note = (f"prefill logits from the f32 model flash {rel['fx']:.4g}, naive "
                      f"{rel['nx']:.4g} (flash <= 1.1x naive), flash vs naive {rel['fn']:.4g}")
    else:
        bf = rel_l2([(lf, lx)])
        check(bf <= XLSTM_BF16_BOUND, f"{cfg.name}: bf16 prefill logits are {bf:.4g} relative "
              f"l2 from the f32 model (bound {XLSTM_BF16_BOUND})")
        out["bf16_vs_f32_rel_l2"] = bf
        exact_note = (f"prefill logits bf16 vs f32 rel l2 {bf:.4g} (bound "
                      f"{XLSTM_BF16_BOUND})")
    del lf, ln, lx
    gc.collect()
    torch.cuda.empty_cache()
    tag = {"hybrid": "hybrid a", "ssm": "ssm c", "audio": "audio a"}[cfg.family]
    behind = (f" behind {cfg.encoder_seq} frames each" if frames is not None else "")
    frame_rate = (f", {out['prefill_frames_per_s']:,.0f} frames/s" if frames is not None else "")
    print(f"[{tag}] {cfg.name} at full width and "
          f"depth ({n_params:,} params, bf16, {weights / 2**30:.2f} GiB of weights, "
          f"made in {init_s:.1f} s): {n} prompts of {s} tokens{behind} prefilled in "
          f"{run['prefill_s'] * 1e3:.1f} ms ({out['prefill_tokens_per_s']:,.0f} tokens/s"
          f"{frame_rate}), "
          f"{DECODE_STEPS} greedy decode steps in {run['decode_s'] * 1e3:.1f} ms "
          f"({out['decode_tokens_per_s']:.1f} tokens/s), pos {s + DECODE_STEPS}; peak memory "
          f"{peak / 2**30:.2f} GiB; {fa.SM90_NAME} launches {counts.get(fa.SM90_NAME, 0)} a "
          f"prefill, no other flash kernel; decode vs forward over {run['forward_tokens']} "
          f"tokens rel l2 {xrun['decode_rel_l2']:.4g} f32 (bound {DECODE_F32_BOUND}), "
          f"{run['decode_rel_l2']:.4g} bf16; from the f32 forward bf16 decode {dec_x:.4g}, bf16 "
          f"forward {fwd_x:.4g} (decode <= {DECODE_BF16_RATIO}x forward); {exact_note}; "
          f"first greedy token equal to f32's on {first_equal} of {n} | {card}", flush=True)
    return out


def recurrent_train(torch, dev, card: str, arch: str) -> dict:
    """24(b) and 24(c): ``python -m repro_torch.launch.train`` at full width
    and depth for RECURRENT_TRAIN_STEPS steps (16 actors x RECURRENT_SEQ
    tokens, replay 8,192 x K=128, batch 8, remat; Hymba with flash): a finite loss, grad
    norm (so finite gradients) and Q mean at every step, finite parameters,
    and the launches the code predicts: one descent (#1) and one gather (#2)
    a step, and for Hymba three flash forwards (online, target, the remat's
    recompute) and one dQ and one dK/dV a layer a step, none of the f32
    kernels; none for xLSTM."""
    import shutil
    import tempfile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    empty_card(torch, dev, f"{arch} training")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_recurrent_")
    seq = RECURRENT_SEQ[arch]
    argv = ["--arch", arch, "--seq", str(seq), *RECURRENT_TRAIN, "--ckpt-dir", ckpt,
            "--seed", str(SEED)]
    if arch == "hymba_1_5b":
        argv += ["--attn-impl", "flash"]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        # the run's final checkpoint (18.8 GB at Hymba), which nothing
        # reads, observed and not written
        with unwritten_saves() as saves:
            res = train.main(argv)
        counts = dict(ops.launch_counts)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    cfg, hist, state = res["cfg"], res["history"], res["state"]
    steps = len(hist)
    check([step for step, _ in saves] == [RECURRENT_TRAIN_STEPS],
          f"{cfg.name} training: final saves {saves}, expected one at step "
          f"{RECURRENT_TRAIN_STEPS}")
    layers = cfg.num_layers if cfg.family == "hybrid" else 0
    want = {"sumtree_sample": steps, "gather": steps, fa.SM90_NAME: 3 * layers * steps,
            fa.DQ_SM90_NAME: layers * steps, fa.DKV_SM90_NAME: layers * steps,
            fa.NAME: 0, fa.DQ_NAME: 0, fa.DKV_NAME: 0, "sample_gather": 0, "sumtree_update": 0}
    check(steps == RECURRENT_TRAIN_STEPS and all(counts.get(k, 0) == v for k, v in want.items()),
          f"{cfg.name} training: {steps} steps, launches {counts}, the code predicts {want}")
    check(all(math.isfinite(h[k]) for h in hist for k in ("loss", "grad_norm", "q_mean")),
          f"{cfg.name} training: a non-finite loss, grad norm or Q mean: {hist}")
    check(all(bool(torch.isfinite(p).all()) for p in state.params.parameters()),
          f"{cfg.name} training: non-finite parameters after the steps")
    n_params = sum(p.numel() for p in state.params.parameters())
    out = {"model": cfg.name, "params": n_params, "steps": steps, "seq": seq,
           "collect_s": [h["collect_s"] for h in hist], "train_s": [h["train_s"] for h in hist],
           "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
           "peak_memory_bytes": res["peak_memory_bytes"] or 0, "launches": counts,
           "seconds": res["seconds"], "flash_layers": layers}
    del res, state
    print(f"[{'hybrid b' if cfg.family == 'hybrid' else 'ssm c'}] launch.train --arch {arch} at "
          f"full width and depth ({n_params / 1e9:.3f} B params, bf16{', flash' if layers else ''}"
          f", remat), 16 actors x {seq} tokens, batch 8: {steps} steps, collect "
          f"{', '.join(f'{x:.2f}' for x in out['collect_s'])} s, train step "
          f"{', '.join(f'{x * 1e3:.1f}' for x in out['train_s'])} ms; losses "
          f"{out['loss']}, grad norms {out['grad_norm']} (finite); launches {counts} as predicted; "
          f"peak memory {out['peak_memory_bytes'] / 2**30:.2f} GiB | {card}", flush=True)
    return out


def flash_bwd_times(torch, dev, gen, n: int, s: int, hd: int, attention: str, window: int,
                    is_global: bool, causal: bool = True) -> dict:
    """The Hopper dQ and dK/dV kernels at (n, s, hd) bf16, causal (or not),
    under ``attention``'s mask, first held to the plain backward in f32 on the same
    inputs (``parity.flash_bwd_check``), then timed beside their bounds
    (phase 14's: 3 and 4 products of 2·hd flops a reachable pair), their
    plain versions and one SDPA backward call, causal or not (the mask
    reaches the causal pairs, or all, only when the window does not bite,
    which the caller picks)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import parity as par

    q, k, v, do = [(torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
                   for _ in range(4)]
    mask_args = (attention, window, causal, is_global)
    pos = torch.arange(s, device=dev)
    pairs = int(fa.attention_mask(pos, pos, *mask_args).sum())
    check(pairs == (s * (s + 1) // 2 if causal else s * s), f"flash_bwd_times at ({n}, {s}, "
          f"{hd}): the mask must be the {'causal' if causal else 'full'} one for SDPA's "
          "backward to compute the same function")
    o, lse = fa.flash_attention_cuda(q, k, v, *mask_args)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, *mask_args)
    got = (fa.flash_attention_dq_sm90_cuda(*args), *fa.flash_attention_dkv_sm90_cuda(*args))
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), *mask_args)
    torch.cuda.synchronize()
    rep = par.flash_bwd_check(*got, *ref)
    shape = f"({n}, {s}, {hd}) bf16 {'causal' if causal else 'non-causal'}, {attention} {window}"
    check(rep.ok, f"the Hopper backward pair at {shape}: {rep}")
    del got, ref
    backend, lib = sdpa_backward(torch, q[None], k[None], v[None], do[None], causal)
    lib_ms = device_ms(torch, lib)
    reads = 4 * n * s * hd * 2 + 2 * n * s * 4
    out = {}
    for name, kern, plain, grads, work, nout in (
            (fa.DQ_SM90_NAME, fa.flash_attention_dq_sm90_cuda, fa.flash_attention_dq_plain,
             ("dq",), 3, 1),
            (fa.DKV_SM90_NAME, fa.flash_attention_dkv_sm90_cuda, fa.flash_attention_dkv_plain,
             ("dk", "dv"), 4, 2)):
        b_ms, b_by = bound(reads + nout * n * s * hd * 2, work * 2 * hd * n * pairs,
                           BF16_OPS_PER_S)
        t = {"shape": shape, "ms": device_ms(torch, lambda: kern(*args)),
             "plain_ms": device_ms(torch, lambda: plain(*args)), "library_ms": lib_ms,
             "library": f"one SDPA {backend} backward call (dQ, dK and dV together)",
             "bound_ms": b_ms, "bound_by": b_by, "call_ms": call_ms(torch, lambda: kern(*args)),
             "max_abs_err": max(rep.per[g][0] for g in grads),
             "bf16_max_ulps_beyond_atol": max(rep.per[g][1] for g in grads)}
        check(all(math.isfinite(t[x]) for x in ("ms", "plain_ms", "library_ms")),
              f"timing of {name} at {shape} is not finite")
        out[name] = t
    return out


def hybrid_ssm_phase(torch, dev, card: str) -> dict:
    """Phase 24: (a) Hymba-1.5B served at full width and depth
    (``prefill_and_decode``), (b) trained by ``launch.train`` for one step
    (``recurrent_train``), (c) xLSTM-125M trained and served the same way,
    each alone on the card; then (d) the Hopper forward at Hymba's prefill
    shape (100, 2048, 64), local (sliding 1,024) and global, and the forward
    and the backward pair at its training shape (200, 128, 64) local, each
    held to its plain version first, beside its bound, plain time and SDPA."""
    from repro_torch.kernels import flash_attention as fa

    out = {"hymba_serve": prefill_and_decode(torch, dev, card, "hymba_1_5b"),
           "hymba_train": recurrent_train(torch, dev, card, "hymba_1_5b"),
           "xlstm_train": recurrent_train(torch, dev, card, "xlstm_125m"),
           "xlstm_serve": prefill_and_decode(torch, dev, card, "xlstm_125m")}
    empty_card(torch, dev, "the hd-64 kernel times")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    out["flash_times"] = {}
    for what, args in (("Hymba's prefill, a local layer", (100, 2048, 64, "sliding", 1024, False)),
                       ("Hymba's prefill, a global layer", (100, 2048, 64, "sliding", 1024, True)),
                       ("Hymba's training, a local layer", (200, 128, 64, "sliding", 1024, False))):
        t = flash_fwd_times(torch, dev, gen, *args, parity=True)
        out["flash_times"][what] = t
        print(f"[times] {fa.SM90_NAME} at {what} {t['shape']} ({t['pairs']:,} pairs), against "
              f"its plain version max |err| {t['max_abs_err']:.3g}: device {t['ms'] * 1e3:.1f} us "
              f"(plain {t['plain_ms'] * 1e3:.1f} us, SDPA {t['library_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, call {t['call_ms'] * 1e3:.1f} us)"
              f" | {card}", flush=True)
        torch.cuda.empty_cache()
    out["bwd_times"] = flash_bwd_times(torch, dev, gen, 200, 128, 64, "sliding", 1024, False)
    for name, t in out["bwd_times"].items():
        print(f"[times] {name} at Hymba's training, a local layer {t['shape']}, against the plain "
              f"backward max |err| {t['max_abs_err']:.3g}: device {t['ms'] * 1e3:.1f} us (plain "
              f"{t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.2f} us by "
              f"{t['bound_by']}, call {t['call_ms'] * 1e3:.1f} us); {t['library']} "
              f"{t['library_ms'] * 1e3:.1f} us | {card}", flush=True)
    torch.cuda.empty_cache()
    print(f"[hybrid ssm rate] {json.dumps(out)}", flush=True)
    return out


# -- phase 25: the audio family at full width ---------------------------------------

# 25(b): rows x text tokens of a train step, each row behind its 1,500 frames
WHISPER_TRAIN = (8, 128)
WHISPER_TRAIN_STEPS = 2


def whisper_train(torch, dev, card: str) -> dict:
    """25(b): ``agents.token_dqn.train_step`` on Whisper-medium at full width
    and depth (bf16, flash, remat, f32 Adam moments), WHISPER_TRAIN_STEPS
    steps on one batch of WHISPER_TRAIN rows x tokens and their frames: a
    finite loss, grad norm and Q mean each step, every parameter tensor moved,
    finite parameters, and each step's launches as the code predicts: three
    #5 a decoder layer (online, target, the remat's recompute; the encoder's
    1,500 frames and the cross-attention take the naive path) and one #6 and
    one #7, none of the f32 kernels; each step's seconds and the peak memory."""
    import numpy as np

    from repro_torch.agents import token_dqn
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    empty_card(torch, dev, "Whisper-medium training")
    cfg = dataclasses.replace(get_config("whisper_medium"), attn_impl="flash")
    check(cfg.remat and model_shape(cfg) == WHISPER_SHAPE, f"not Whisper-medium with remat: {cfg}")
    tcfg = token_dqn.TokenDQNConfig()
    t0 = time.perf_counter()
    state = token_dqn.init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated(dev)
    b, s = WHISPER_TRAIN
    rng = np.random.RandomState(SEED + 25)
    dones = np.zeros((b, s), np.float32)
    dones[:, s // 2 - 1] = 1.0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int64),
        "actions": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int64),
        "rewards": rng.uniform(0, 1, (b, s)).astype(np.float32), "dones": dones,
        "is_weights": rng.uniform(0.5, 1, b).astype(np.float32)}.items()}
    batch["extra_embeds"] = (torch.randn((b, cfg.encoder_seq, cfg.d_model), device=dev,
                                         generator=torch.Generator(device=dev).manual_seed(
                                             SEED + 26)) * 0.1).to(torch.bfloat16)
    before = [p.detach().clone() for p in state.params.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    layers = cfg.num_layers
    want = {fa.SM90_NAME: 3 * layers, fa.DQ_SM90_NAME: layers, fa.DKV_SM90_NAME: layers,
            fa.NAME: 0, fa.DQ_NAME: 0, fa.DKV_NAME: 0}
    steps = []
    for _ in range(WHISPER_TRAIN_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics, tds = token_dqn.train_step(cfg, token_dqn.NO_SHARDING, tcfg, state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        rec = {"seconds": secs, "launches": counts,
               **{k: float(metrics[k]) for k in ("loss", "grad_norm", "q_mean")}}
        check(all(counts.get(k, 0) == v for k, v in want.items()),
              f"Whisper-medium train step: launches {counts}, the code predicts {want}")
        check(all(math.isfinite(rec[k]) for k in ("loss", "grad_norm", "q_mean"))
              and tds.shape == (b,) and bool(torch.isfinite(tds).all()),
              f"Whisper-medium train step: a non-finite loss, grad norm, Q mean or |TD|: {rec}")
        steps.append(rec)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = sum(not torch.equal(a, p.detach()) for a, p in zip(before, state.params.parameters()))
    n_tensors = len(before)
    check(moved == n_tensors and all(bool(torch.isfinite(p).all())
                                     for p in state.params.parameters()),
          f"Whisper-medium training: {moved} of {n_tensors} parameter tensors moved, or a "
          "parameter is not finite")
    n_params = sum(p.numel() for p in state.params.parameters())
    del state, before, batch
    out = {"model": cfg.name, "params": n_params, "init_s": init_s, "rows": b, "tokens": s,
           "frames": cfg.encoder_seq, "steps": steps, "resident_bytes": resident,
           "peak_memory_bytes": peak, "tensors_moved": moved}
    secs = ", ".join(f"{r['seconds']:.3f}" for r in steps)
    print(f"[audio b] token_dqn.train_step on {cfg.name} at full width and depth "
          f"({n_params:,} params, bf16, flash, remat; state {resident / 2**30:.2f} GiB made in "
          f"{init_s:.1f} s), {b} rows x {s} tokens behind {cfg.encoder_seq} frames each: steps "
          f"{secs} s, losses "
          f"{[r['loss'] for r in steps]}, grad norms {[r['grad_norm'] for r in steps]} "
          f"(finite); {moved} of {n_tensors} parameter tensors moved; launches a step "
          f"{steps[-1]['launches']} as predicted; peak memory {peak / 2**30:.2f} GiB | {card}",
          flush=True)
    return out


def audio_phase(torch, dev, card: str) -> dict:
    """Phase 25: (a) Whisper-medium prefilled and decoded at full width and
    depth (``prefill_and_decode``), (b) trained for 2 steps
    (``whisper_train``), each alone on the card; then (c) the Hopper forward
    and backward pair at Whisper's shapes: the encoder's width at 1,536
    frames non-causal (the path an ``encoder_seq`` that is a multiple of 128
    takes), a ragged (3, 1000, 64) non-causal and the decoder's train step
    (128, 128, 64) causal, each held to its plain version first, beside its
    bound, plain time and SDPA."""
    from repro_torch.kernels import flash_attention as fa

    out = {"serve": prefill_and_decode(torch, dev, card, "whisper_medium"),
           "train": whisper_train(torch, dev, card)}
    empty_card(torch, dev, "the Whisper kernel times")
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    out["flash_times"], out["bwd_times"] = {}, {}
    for what, (n, s, causal) in (("Whisper's encoder width", (64, 1536, False)),
                                 ("a ragged length", (3, 1000, False)),
                                 ("Whisper's decoder, a train step", (128, 128, True))):
        t = flash_fwd_times(torch, dev, gen, n, s, 64, parity=True, causal=causal)
        out["flash_times"][what] = t
        print(f"[times] {fa.SM90_NAME} at {what} {t['shape']} ({t['pairs']:,} pairs), against "
              f"its plain version max |err| {t['max_abs_err']:.3g}: device {t['ms'] * 1e3:.1f} us "
              f"(plain {t['plain_ms'] * 1e3:.1f} us, SDPA {t['library_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, call {t['call_ms'] * 1e3:.1f} us)"
              f" | {card}", flush=True)
        for name, tb in flash_bwd_times(torch, dev, gen, n, s, 64, "full", 0, True,
                                        causal).items():
            out["bwd_times"].setdefault(name, {})[what] = tb
            print(f"[times] {name} at {what} {tb['shape']}, against the plain backward max "
                  f"|err| {tb['max_abs_err']:.3g}: device {tb['ms'] * 1e3:.1f} us (plain "
                  f"{tb['plain_ms'] * 1e3:.1f} us, bound {tb['bound_ms'] * 1e3:.2f} us by "
                  f"{tb['bound_by']}, call {tb['call_ms'] * 1e3:.1f} us); {tb['library']} "
                  f"{tb['library_ms'] * 1e3:.1f} us | {card}", flush=True)
        torch.cuda.empty_cache()
    print(f"[audio rate] {json.dumps(out)}", flush=True)
    return out


# -- phase 26: model sharding, the token-DQN train step on a mesh of ranks ------

SHARD_B, SHARD_S = 8, 128       # phase 26's batch: phase 13's (8 x TRAIN_SEQ)
SHARD_SEED = SEED + 26
# phase 13's first run (--mesh host), which 26(d) is held to: fingerprints of
# its final state, its history and its replay launches
PHASE13_HOST: dict = {}


def fingerprints(torch, tensors: dict) -> dict:
    """{name: (dtype, shape, two 64-bit integer sums)} of each tensor's bytes:
    the words as integers, summed plain and weighted by (index mod 65,521)
    + 1, in int64 (integer sums wrap the same in any order).  Equal
    fingerprints stand for equal bytes: a difference in any word moves the
    weighted sum unless it is a multiple of 2^64."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().contiguous()
        words = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[
            t.element_size()]
        x = t.reshape(-1).view(words).to(torch.int64)
        w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
        out[name] = (str(t.dtype), tuple(t.shape), int(x.sum()), int((x * w).sum()))
    return out


def shard_token_batch(torch, cfg, dev, b: int = SHARD_B, s: int = SHARD_S,
                      seed: int = SHARD_SEED) -> dict:
    """A seeded token-DQN batch (b, s) on ``dev``: tokens and actions over
    the vocabulary, rewards in [0, 1), a terminal at position s/2 - 1,
    importance weights in [0.5, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dones = torch.zeros((b, s), device=dev)
    dones[:, s // 2 - 1] = 1.0
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev,
                                    dtype=torch.int32),
            "actions": torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev,
                                     dtype=torch.int32),
            "rewards": torch.rand((b, s), generator=g, device=dev), "dones": dones,
            "is_weights": torch.rand((b,), generator=g, device=dev) * 0.5 + 0.5}


def device_bytes(torch, dev) -> tuple:
    """(bytes the caching allocator was asked for, bytes it allocated) on
    ``dev`` now: the second rounds each request up to its block (512 B, and
    a large block not split when its rest would be under 1 MiB)."""
    return (torch.cuda.memory_stats(dev)["requested_bytes.all.current"],
            torch.cuda.memory_allocated(dev))


COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
               "all_to_all_single")


def collective_traffic(torch):
    """A dispatch mode that counts the functional collectives DTensor
    redistributes through and the bytes this rank puts in: {op: [calls,
    input bytes]}.  It sees the calling thread only: the backward's
    collectives run on the autograd engine's device thread and are not
    counted (``mesh.HOST_COPIES`` counts the all-gathers of both).  The
    host-staged all-gather's inner CPU call is left out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.name()
            if name.startswith("_c10d_functional::") and name.split("::")[1] in COLLECTIVES:
                x = args[0]
                if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                    entry = self.ops.setdefault(name.split("::")[1], [0, 0])
                    entry[0] += 1
                    entry[1] += x.numel() * x.element_size()
            return func(*args, **(kwargs or {}))

    return Traffic()


def _flash_counts(ops, fa) -> dict:
    return {k: ops.launch_counts.get(k, 0) for k in (fa.SM90_NAME, fa.DQ_SM90_NAME,
                                                     fa.DKV_SM90_NAME, fa.NAME, fa.DQ_NAME,
                                                     fa.DKV_NAME)}


def _my_piece(torch, full, spec, device_mesh):
    """This rank's piece of ``full`` under ``spec`` (a plain tensor)."""
    from repro_torch.launch import specs as S
    return S.shard_tensor(full, spec, device_mesh).to_local().clone()


def _sharded_state(torch, cfg, shd, tcfg, dev, device_mesh):
    """The train state drawn from SHARD_SEED (``token_dqn.init_train_state``'s
    draw) cut into this rank's pieces by ``launch/sharded.py::
    shard_train_state``."""
    from repro_torch.launch import sharded
    from repro_torch.models import backbone

    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SHARD_SEED))
    target = copy.deepcopy(params).requires_grad_(False)
    return sharded.shard_train_state(cfg, shd, tcfg, params, target, device_mesh)


def _reference_moments(torch, cfg, tcfg, dev, batch, dtype, pspec, device_mesh) -> dict:
    """One unsharded ``train_step`` of the bf16 model drawn from
    SHARD_SEED, in ``dtype`` ("float32": the same bf16 weights cast to f32)
    → this rank's pieces of the new first moments (f32: (1 - b1) × the
    clipped gradient), the loss, grad norm and per-sequence |TD|."""
    from repro_torch.agents import token_dqn
    from repro_torch.models import backbone
    from repro_torch.optim import adam

    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SHARD_SEED))
    c = dataclasses.replace(cfg, dtype=dtype)
    if dtype != cfg.dtype:
        wide = backbone.Backbone(c, dev)
        with torch.no_grad():
            for p, q in zip(wide.parameters(), params.parameters()):
                p.copy_(q)
        params = wide
    target = copy.deepcopy(params).requires_grad_(False)
    state = token_dqn.TrainState(params, target, adam.init(params.parameters(), tcfg.opt),
                                 torch.zeros((), dtype=torch.int32, device=dev))
    state, metrics, tds = token_dqn.train_step(c, token_dqn.NO_SHARDING, tcfg, state, batch)
    names = [n for n, _ in params.named_parameters()]
    pieces = [_my_piece(torch, m, pspec[n], device_mesh) for n, m in zip(names, state.opt.m)]
    out = {"m": pieces, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "tds": tds.float().cpu()}
    del state, params, target
    return out


def _replication(torch, spec, shape, device_mesh) -> int:
    """On how many ranks of the mesh each piece of a tensor lives."""
    from repro_torch.launch import specs as S
    return device_mesh.size() // S.num_shards(shape, spec, device_mesh)


def _sharded_step_rank(torch, dev, cfg, tcfg, shd, mesh_shape) -> dict:
    """One rank of 26(b) or 26(c): this rank's pieces of the state drawn from
    SHARD_SEED (its resident bytes against ``tree_device_bytes``), the
    unsharded f32 and bf16 steps' first moments (each rank in turn, its
    pieces kept), then one sharded ``train_step`` with the kernels' launches
    counted, and the squared distances of the moments summed over the mesh
    (each piece once)."""
    import gc

    import torch.distributed as dist

    from repro_torch.agents.base import state_tensors
    from repro_torch.agents import token_dqn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded
    from repro_torch.models import backbone

    mesh = meshlib.small_mesh(*mesh_shape)
    dm = meshlib.to_device_mesh(mesh, dev.type)
    batch = shard_token_batch(torch, cfg, dev)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = device_bytes(torch, dev)
    t0 = time.perf_counter()
    state = _sharded_state(torch, cfg, shd, tcfg, dev, dm)
    gc.collect()
    torch.cuda.synchronize()
    requested, allocated = (x - y for x, y in zip(device_bytes(torch, dev), base))
    init_s = time.perf_counter() - t0
    want = sharded.state_device_bytes(cfg, shd, state, dm)
    n_tensors = len(state_tensors(state))
    local = sharded.local_state_bytes(state)
    pspec = backbone.param_specs(cfg, shd, state.params)
    # the unsharded references, one rank at a time (each holds a whole
    # state while it steps: 30 GB in f32 at InternLM2-1.8B)
    refs = {}
    for turn in range(dm.size()):
        dist.barrier()
        if turn == dist.get_rank():
            for dtype in ("float32", "bfloat16"):
                refs[dtype] = _reference_moments(torch, cfg, tcfg, dev, batch, dtype, pspec, dm)
                gc.collect()
                torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    meshlib.HOST_COPIES["all_gather_into_tensor"] = 0
    t0 = time.perf_counter()
    with collective_traffic(torch) as traffic:
        state, metrics, tds = token_dqn.train_step(cfg, shd, tcfg, state,
                                                   sharded.shard_batch(shd, batch, dm))
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _flash_counts(ops, fa)
    host_copies = dict(meshlib.HOST_COPIES)
    peak = torch.cuda.max_memory_allocated(dev)
    names = [n for n, _ in state.params.named_parameters()]
    # each leaf's squared distances, summed over the mesh (each piece once)
    sums = torch.zeros((len(names), 4), dtype=torch.float64, device=dev)
    for i, (n, p) in enumerate(zip(names, state.params.parameters())):
        mine = state.opt.m[i].to_local().double()
        r32, r16 = refs["float32"]["m"][i].double(), refs["bfloat16"]["m"][i].double()
        share = 1.0 / _replication(torch, pspec[n], tuple(p.shape), dm)
        sums[i] = share * torch.stack([((mine - r32) ** 2).sum(), ((r16 - r32) ** 2).sum(),
                                       (r32 ** 2).sum(), ((mine - r16) ** 2).sum()])
    dist.all_reduce(sums)
    sums = sums.cpu()
    d_sharded, d_bf16, norm, d_pair = (float(x) for x in sums.sum(0).sqrt())
    leaves = _leaf_distances(torch, names, sums)
    ref32 = refs["float32"]
    return {"mesh": list(mesh_shape), "resident_bytes": requested,
            "allocated_bytes": allocated, "want_bytes": want,
            "local_bytes": local, "n_tensors": n_tensors, "init_s": init_s, "step_s": step_s,
            "launches": launches, "host_copies": host_copies, "peak_bytes": peak,
            "collectives": traffic.ops,
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "ref_loss": {d: r["loss"] for d, r in refs.items()},
            "ref_grad_norm": {d: r["grad_norm"] for d, r in refs.items()},
            "tds": tds.float().cpu().tolist(), "ref_tds": ref32["tds"].tolist(),
            "m_rel_sharded_vs_f32": d_sharded / norm, "m_rel_bf16_vs_f32": d_bf16 / norm,
            "m_rel_sharded_vs_bf16": d_pair / norm, "leaves": leaves,
            "scalar_rel_from_f32": {
                side: {"loss": abs(loss - refs["float32"]["loss"]) / abs(refs["float32"]["loss"]),
                       "grad_norm": abs(gn - refs["float32"]["grad_norm"])
                       / abs(refs["float32"]["grad_norm"]),
                       "|td|": float((t - ref32["tds"]).norm() / ref32["tds"].norm())}
                for side, loss, gn, t in (
                    ("sharded", float(metrics["loss"]), float(metrics["grad_norm"]),
                     tds.float().cpu()),
                    ("bf16", refs["bfloat16"]["loss"], refs["bfloat16"]["grad_norm"],
                     refs["bfloat16"]["tds"]))}}


def _leaf_distances(torch, names, sums) -> dict:
    """Per-leaf relative l2 distances from the f32 step's first moments, of
    the sharded step and of the bf16 unsharded step (``sums``: each leaf's
    squared distances and squared norm, (leaves, 4)): the median and the
    worst leaf of each side, and the leaves whose f32 moment is all zero
    (no relative distance) with the sharded step's distance there."""
    d = sums.sqrt()
    live = d[:, 2] > 0
    out = {}
    for side, col in (("sharded", 0), ("bf16", 1)):
        rel = d[live, col] / d[live, 2]
        worst = int(rel.argmax())
        out[side] = {"median": float(rel.median()), "worst": float(rel[worst]),
                     "worst_leaf": [n for n, ok in zip(names, live.tolist()) if ok][worst],
                     "p90": float(rel.quantile(0.9))}
    out["zero"] = {n: [float(d[i, 0]), float(d[i, 1])]
                   for i, n in enumerate(names) if not bool(live[i])}
    out["leaves"] = len(names)
    return out


def _f32_step_rank(torch, dev, shd, mesh_shape) -> dict:
    """26(c) in f32: InternLM2's SMOKE width in f32 (flash: the f32 kernels)
    on this mesh against the unsharded f32 step of the same state and
    batch on this rank.  Only the order of the sums differs between the
    two, so they are held to tests/test_torch_token_dqn.py's rules for two
    f32 implementations of the step: loss, grad norm and every |TD| at
    rtol 1e-5 / atol 1e-6, each leaf of m and v at rtol 1e-4 plus 1e-5 of
    the leaf's largest magnitude (a reduction left partial over a mesh axis
    moves a leaf by a whole part of it, far past either).  → what falls
    outside, and the largest difference of m or v as a share of its
    bound."""
    from repro_torch.agents import token_dqn
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded
    from repro_torch.models import backbone

    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl="flash",
                              dtype="float32")
    tcfg = token_dqn.TokenDQNConfig()
    batch = shard_token_batch(torch, cfg, dev)
    dm = meshlib.to_device_mesh(meshlib.small_mesh(*mesh_shape), dev.type)
    ref = token_dqn.init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(
        SHARD_SEED))
    ref, m_u, tds_u = token_dqn.train_step(cfg, token_dqn.NO_SHARDING, tcfg, ref, batch)
    state = _sharded_state(torch, cfg, shd, tcfg, dev, dm)
    state, m_s, tds_s = token_dqn.train_step(cfg, shd, tcfg, state,
                                             sharded.shard_batch(shd, batch, dm))
    pspec = backbone.param_specs(cfg, shd, state.params)
    far, worst = [], 0.0
    for i, (n, _) in enumerate(state.params.named_parameters()):
        for key in ("m", "v"):
            want = getattr(ref.opt, key)[i].detach()
            piece = _my_piece(torch, want, pspec[n], dm)
            bound = 1e-4 * piece.abs() + 1e-5 * want.abs().max()
            diff = (getattr(state.opt, key)[i].to_local() - piece).abs()
            worst = max(worst, float((diff / bound.clamp_min(1e-30)).max()))
            if bool((diff > bound).any()):
                far.append(f"{key} {n}")
    scalars = {}
    for k in ("loss", "grad_norm"):
        a, b = float(m_s[k]), float(m_u[k])
        scalars[k] = [a, b]
        if abs(a - b) > 1e-6 + 1e-5 * abs(b):
            far.append(k)
    tds_s, tds_u = tds_s.float().cpu(), tds_u.float().cpu()
    if bool(((tds_s - tds_u).abs() > 1e-6 + 1e-5 * tds_u.abs()).any()):
        far.append("|td|")
    return {"mesh": list(mesh_shape), "far": far, "worst_share": worst, "scalars": scalars,
            "td_max_abs_diff": float((tds_s - tds_u).abs().max()),
            "leaves": 2 * len(pspec)}


def _sharding_ranks(rank: int, device: str) -> dict:
    """26(b) and (c) on one of two gloo ranks sharing the card: InternLM2-1.8B
    at full width and depth on a 1×2 (data, model) mesh, then its SMOKE
    width in bf16 on a 2×1 mesh; then 27(b)'s serving (``_serve27_rank``),
    which phase 27 checks."""
    import gc

    import torch

    from repro_torch.agents import token_dqn
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.train import token_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    shd = meshlib.sharding_config(False)
    tcfg = token_config()
    full = dataclasses.replace(get_config("internlm2_1_8b"), attn_impl="flash")
    out = {"b": _sharded_step_rank(torch, dev, full, tcfg, shd, (1, 2))}
    smoke = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl="flash",
                                dtype="bfloat16")
    out["c"] = _sharded_step_rank(torch, dev, smoke, token_dqn.TokenDQNConfig(), shd, (2, 1))
    out["c32"] = [_f32_step_rank(torch, dev, shd, m) for m in ((2, 1), (1, 2))]
    # 27(b) on the same two ranks, their training state freed (a spawn saved)
    gc.collect()
    torch.cuda.empty_cache()
    out["serve27"] = _serve27_rank(rank, device)
    return out


def _sharding_one_by_one(torch, dev, card: str) -> dict:
    """26(a): world 1 over NCCL in this process; one unsharded ``train_step``
    of InternLM2-1.8B at full width and depth (bf16, flash, remat), then the
    same state drawn again, placed on a 1×1 mesh and stepped through the
    sharded path: loss, grad norm, |TD| and every updated parameter bit for
    bit, and the same flash launches."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.agents import token_dqn
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded
    from repro_torch.launch.train import token_config

    cfg = dataclasses.replace(get_config("internlm2_1_8b"), attn_impl="flash")
    tcfg, shd = token_config(), meshlib.sharding_config(False)
    batch = shard_token_batch(torch, cfg, dev)
    state = token_dqn.init_train_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(
        SHARD_SEED))
    ops.reset_launch_counts()
    state, m_u, tds_u = token_dqn.train_step(cfg, token_dqn.NO_SHARDING, tcfg, state, batch)
    torch.cuda.synchronize()
    counts_u = _flash_counts(ops, fa)
    new_u = [p.detach() for p in state.params.parameters()]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
    try:
        dm = meshlib.to_device_mesh(meshlib.small_mesh(1, 1), dev.type)
        base = device_bytes(torch, dev)
        state = _sharded_state(torch, cfg, shd, tcfg, dev, dm)
        gc.collect()
        torch.cuda.synchronize()
        requested, allocated = (x - y for x, y in zip(device_bytes(torch, dev), base))
        want = sharded.state_device_bytes(cfg, shd, state, dm)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m_s, tds_s = token_dqn.train_step(cfg, shd, tcfg, state,
                                                 sharded.shard_batch(shd, batch, dm))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts_s = _flash_counts(ops, fa)
        new_s = [p.detach().to_local() for p in state.params.parameters()]
        differ = [i for i, (a, b) in enumerate(zip(new_s, new_u)) if not same_bytes(torch, a, b)]
        same = {k: same_bytes(torch, m_s[k].float().reshape(1), m_u[k].float().reshape(1))
                for k in ("loss", "grad_norm")}
        same["|td|"] = same_bytes(torch, tds_s, tds_u)
        n = len(new_u)
        del state, new_s
    finally:
        dist.destroy_process_group()
    del new_u
    gc.collect()
    torch.cuda.empty_cache()
    return {"differ": differ, "same": same, "n_params": n, "counts_unsharded": counts_u,
            "counts_sharded": counts_s, "resident_bytes": requested,
            "allocated_bytes": allocated, "want_bytes": want,
            "step_s": step_s, "loss": float(m_u["loss"]), "grad_norm": float(m_u["grad_norm"])}


def sharding_ranks(device: str) -> list:
    """26(b)-(c)'s two gloo ranks on the card (and 27(b)'s serving on
    them) → their results.  They touch nothing of this process but the
    card, so ``main`` runs them beside phases 15-16, 22 and 19."""
    from repro_torch.launch import mesh as meshlib

    return meshlib.spawn(_sharding_ranks, 2, device, backend="gloo", device=device,
                         timeout_s=900)


def sharding_phase(torch, dev, card: str, parts: str = "abcde", ranks=None) -> dict:
    """Phase 26: ``launch/sharded.py`` — (a) a 1×1 mesh bit for bit against
    the unsharded step; (b) a 1×2 mesh of two gloo ranks sharing the card;
    (c) a 2×1 mesh at SMOKE width; (d) ``launch/train.py --mesh 16x16``
    against phase 13's ``--mesh host`` run; (e) every config's state bytes
    per device at 16×16 and 2×16×16.  ``parts`` picks some of them (a
    script that runs the phase alone); ``ranks`` is a future of what
    ``sharding_ranks`` returns, or None to run them here."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    res = {}
    layers = get_config("internlm2_1_8b").num_layers
    want_flash = {fa.SM90_NAME: 3 * layers, fa.DQ_SM90_NAME: layers, fa.DKV_SM90_NAME: layers,
                  fa.NAME: 0, fa.DQ_NAME: 0, fa.DKV_NAME: 0}
    took = {}
    if "a" in parts:
        res["a"] = _sharding_check_a(torch, dev, card, want_flash)
        took["a"] = time.perf_counter() - t_phase
    if "b" in parts or "c" in parts:
        t0 = time.perf_counter()
        ranks = ranks.result() if ranks else sharding_ranks(str(dev))
        res["serve27"] = [r.pop("serve27") for r in ranks]
        res.update(_sharding_check_bc(ranks, card, want_flash))
        took["b, c"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    if "d" in parts:
        t0 = time.perf_counter()
        res["d"] = _sharding_check_d(torch, card)
        took["d"] = time.perf_counter() - t0
    if "e" in parts:
        res["e"] = _sharding_bytes_table(card)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[sharding] phase 26 in {res['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")", flush=True)
    return res


def _sharding_check_a(torch, dev, card: str, want_flash: dict) -> dict:
    a = _sharding_one_by_one(torch, dev, card)
    check(not a["differ"] and all(a["same"].values()),
          f"26(a) the 1x1 sharded step differs from the unsharded one: parameters "
          f"{a['differ'][:6]} of {a['n_params']}, scalars {a['same']}")
    check(a["counts_sharded"] == a["counts_unsharded"] == want_flash,
          f"26(a) flash launches sharded {a['counts_sharded']}, unsharded "
          f"{a['counts_unsharded']}, expected {want_flash}")
    check(a["resident_bytes"] == a["want_bytes"],
          f"26(a) resident {a['resident_bytes']:,} B (requested; {a['allocated_bytes']:,} "
          f"allocated) against tree_device_bytes {a['want_bytes']:,.0f}")
    print(f"[sharding a] internlm2-1.8b at full width and depth (bf16, flash, remat) on a 1x1 "
          f"mesh over nccl: one train_step through launch/sharded.py equals the unsharded "
          f"step bit for bit (loss {a['loss']:.6f}, grad norm {a['grad_norm']:.6f}, |TD|, "
          f"all {a['n_params']} updated parameters); flash launches {a['counts_sharded']} on "
          f"both; resident state {a['resident_bytes']:,} B requested ({a['allocated_bytes']:,} "
          f"allocated) = tree_device_bytes; sharded step {a['step_s']:.2f} s | {card}",
          flush=True)
    return a


def _short(d: dict) -> str:
    return "{" + ", ".join(f"{k} {v:.4g}" for k, v in d.items()) + "}"


def _sharding_check_bc(ranks: list, card: str, want_flash: dict) -> dict:
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for part, what in (("b", "internlm2-1.8b 1x2 (data x model)"),
                       ("c", "internlm2 SMOKE width in bf16, 2x1 (data x model)")):
        rs = [r[part] for r in ranks]
        for rank, r in enumerate(rs):
            check(r["resident_bytes"] == r["local_bytes"] == r["want_bytes"],
                  f"26({part}) rank {rank}: resident {r['resident_bytes']:,} B requested "
                  f"({r['allocated_bytes']:,} allocated), its pieces {r['local_bytes']:,} B, "
                  f"tree_device_bytes {r['want_bytes']:,.0f}")
            if part == "b":
                check(r["launches"] == want_flash,
                      f"26(b) rank {rank}: flash launches {r['launches']}, expected "
                      f"{want_flash} on its heads' shard")
            else:
                check(r["launches"][fa.NAME] > 0 and r["launches"][fa.DQ_NAME] > 0
                      and r["launches"][fa.DKV_NAME] > 0,
                      f"26(c) rank {rank}: flash launches {r['launches']}")
            check(r["m_rel_sharded_vs_f32"] <= 1.1 * r["m_rel_bf16_vs_f32"],
                  f"26({part}): the sharded step's first moments are "
                  f"{r['m_rel_sharded_vs_f32']:.4g} (relative l2) from the f32 unsharded "
                  f"step's, beyond 1.1x the bf16 unsharded step's {r['m_rel_bf16_vs_f32']:.4g}")
            # the same rule on the median leaf and on the worst leaf: a fault
            # confined to small leaves (a norm scale's sum left partial over
            # the model axis) moves them by a whole part of their size
            lv = r["leaves"]
            for stat in ("median", "worst"):
                check(lv["sharded"][stat] <= 1.1 * lv["bf16"][stat],
                      f"26({part}): the {stat} leaf's first moment is {lv['sharded'][stat]:.4g} "
                      f"(relative l2; worst {lv['sharded']['worst_leaf']}) from the f32 "
                      f"unsharded step's, beyond 1.1x the bf16 unsharded step's "
                      f"{lv['bf16'][stat]:.4g} (worst {lv['bf16']['worst_leaf']})")
            check(all(ds <= 1.1 * db for ds, db in lv["zero"].values()),
                  f"26({part}): leaves whose f32 first moment is zero: {lv['zero']}")
            check(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]),
                  f"26({part}) rank {rank}: loss {r['loss']}, grad norm {r['grad_norm']}")
        r = rs[0]
        lv, sc = r["leaves"], r["scalar_rel_from_f32"]
        print(f"[sharding {part}] {what}, two gloo ranks on cuda:0: resident state "
              f"{[x['resident_bytes'] for x in rs]} B a rank requested "
              f"({[x['allocated_bytes'] for x in rs]} allocated) = tree_device_bytes "
              f"{r['want_bytes']:,.0f}; init {[round(x['init_s'], 2) for x in rs]} s, sharded "
              f"step {[round(x['step_s'], 2) for x in rs]} s, peak "
              f"{[round(x['peak_bytes'] / 2**30, 2) for x in rs]} GiB; flash launches a rank "
              f"{[x['launches'] for x in rs]}; rank 0's collectives outside the backward [calls, "
              f"bytes in] "
              f"{r['collectives']}; gloo host copies {r['host_copies']}; first "
              f"moments (the clipped gradient) relative l2 from the f32 unsharded step: "
              f"sharded {r['m_rel_sharded_vs_f32']:.4g}, bf16 unsharded "
              f"{r['m_rel_bf16_vs_f32']:.4g} (sharded vs bf16 unsharded "
              f"{r['m_rel_sharded_vs_bf16']:.4g}); its {lv['leaves']} leaves: median sharded "
              f"{lv['sharded']['median']:.4g}, bf16 {lv['bf16']['median']:.4g}; worst "
              f"sharded {lv['sharded']['worst']:.4g} ({lv['sharded']['worst_leaf']}), bf16 "
              f"{lv['bf16']['worst']:.4g} ({lv['bf16']['worst_leaf']}); 90th percentile "
              f"sharded {lv['sharded']['p90']:.4g}, bf16 {lv['bf16']['p90']:.4g}; "
              f"{len(lv['zero'])} all-zero leaves; loss {r['loss']:.6f} (unsharded f32/bf16 "
              f"{r['ref_loss']}), grad norm {r['grad_norm']:.6f} ({r['ref_grad_norm']}); "
              f"relative distance from f32 (shown, held in f32 below) sharded "
              f"{_short(sc['sharded'])}, bf16 {_short(sc['bf16'])} | {card}", flush=True)
        print(f"[sharding {part} rate] {json.dumps(rs)}", flush=True)
        out[part] = rs
    # (c) in f32 on both meshes: two f32 steps that differ only in the order
    # of their sums, held leaf by leaf and scalar by scalar.  The bf16 runs'
    # loss, grad norm and |TD| are shown and not held to 1.1x the bf16
    # unsharded step's distance: each is one draw of a rounding error, and
    # the ratio of two such draws passes 1.1 about half the time
    for rank, runs in enumerate(r["c32"] for r in ranks):
        for run in runs:
            check(not run["far"],
                  f"26(c) f32 rank {rank} mesh {run['mesh']}: {run['far'][:8]} outside "
                  f"tests/test_torch_token_dqn.py's rules (the largest m or v difference "
                  f"{run['worst_share']:.3g} of its bound); loss, grad norm {run['scalars']}")
    runs = ranks[0]["c32"]
    print(f"[sharding c f32] internlm2 SMOKE width in f32 (flash: the f32 kernels) on "
          + ", ".join(f"{'x'.join(map(str, x['mesh']))}" for x in runs)
          + " (data x model), two gloo ranks on cuda:0, against the unsharded f32 step: all "
          f"{runs[0]['leaves']} leaves of m and v within rtol 1e-4 + 1e-5 of each leaf's "
          f"largest (the largest difference "
          + ", ".join(f"{x['worst_share']:.3g}" for x in runs) + " of its bound"
          + "), loss and grad norm (sharded, unsharded) "
          + ", ".join(str(x["scalars"]) for x in runs)
          + " and every |TD| (largest difference "
          + ", ".join(f"{x['td_max_abs_diff']:.3g}" for x in runs)
          + f") within rtol 1e-5 / atol 1e-6 | {card}", flush=True)
    out["c32"] = [r["c32"] for r in ranks]
    return out


def _sharding_check_d(torch, card: str) -> dict:
    """26(d): ``launch.train --mesh 16x16`` with phase 13's first run's
    arguments (its one final save observed and not written: nothing reads
    it) against that ``--mesh host`` run: every state tensor's fingerprint,
    the history, the replay kernels' launches."""
    import gc
    import shutil
    import tempfile

    from repro_torch.agents.base import state_tensors
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    host = PHASE13_HOST
    check(bool(host), "26(d) needs phase 13's --mesh host run")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_mesh16_")
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with unwritten_saves() as saves:
            run = train.main(host["argv"] + ["--steps", str(TRAIN_STEPS), "--ckpt-every", "0",
                                             "--ckpt-dir", ckpt, "--mesh", "16x16"])
        secs = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        prints = fingerprints(torch, state_tensors(run["state"]))
        hist = [{k: h[k] for k in ("loss", "grad_norm", "q_mean")} for h in run["history"]]
        mesh_desc = run["mesh"].shape
        del run
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    differ = [k for k in host["fingerprints"] if prints.get(k) != host["fingerprints"][k]]
    replay = {k: counts.get(k, 0) for k in ("sumtree_sample", "gather")}
    check(saves == [(TRAIN_STEPS, len(prints))],
          f"26(d) final saves {saves}, expected one at step {TRAIN_STEPS} of {len(prints)} "
          f"tensors")
    check(not differ and hist == host["history"],
          f"26(d) --mesh 16x16 differs from --mesh host: {differ[:6]}, history {hist} against "
          f"{host['history']}")
    check(replay == host["replay_launches"] and all(v >= TRAIN_STEPS for v in replay.values()),
          f"26(d) replay launches {replay} against --mesh host's {host['replay_launches']}")
    print(f"[sharding d] launch.train --arch internlm2_1_8b --mesh 16x16 --steps {TRAIN_STEPS} "
          f"(one process, sharding_config(False), mesh {mesh_desc} never installed) in "
          f"{secs:.1f} s: all {len(prints)} state tensors' fingerprints and the history equal "
          f"phase 13's --mesh host run's; replay launches {replay} as host's | {card}",
          flush=True)
    return {"history": hist, "replay_launches": replay, "tensors": len(prints), "seconds": secs}


def _sharding_bytes_table(card: str) -> dict:
    """26(e): every config's state bytes per device on the production meshes,
    f32 and bf16 moments, from shapes alone."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded
    from repro_torch.launch import specs as S

    table = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        row = {}
        for multi in (False, True):
            shd = meshlib.sharding_config(multi)
            mesh = meshlib.make_production_mesh(multi_pod=multi)
            for moments in ("float32", "bfloat16"):
                leaves, specs = sharded.state_shapes(cfg, shd, moments)
                key = f"{'2x16x16' if multi else '16x16'} {moments} moments"
                row[key] = S.tree_device_bytes(leaves, specs, mesh)
        table[cfg.name] = row
    print("[sharding e] state bytes per device (params, target, Adam count/m/v, step; "
          "launch/specs.py::tree_device_bytes under state_specs), no allocation: "
          + "; ".join(f"{m}: " + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in r.items())
                      for m, r in table.items()) + f" | {card}", flush=True)
    return table


# -- the phases ----------------------------------------------------------------


# -- phase 27: serving on a mesh of ranks, and the dry run ----------------------

SERVE27 = dict(slots=8, max_len=520, buckets=(128, 256, 384, 512), max_new_tokens=8)
# prompts on the bucket edges, so every prefill is a multiple of 128 and takes flash
SERVE27_LENS = (128, 256, 384, 512, 512, 384, 256, 128)
SERVE27_POSITIONS = 32          # logits compared at this many seeded positions a prompt
SERVE27_LOGIT_PROMPTS = 4       # 27(b)'s logits rule on the first four: each length once
SERVE27_SEED = SEED + 27
DRYRUN27_ARCH = "internlm2_1_8b"
DRYRUN27_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def serve27_inputs(vocab: int):
    """The requests' prompts and, for each, its compared positions (seeded,
    the last included)."""
    import numpy as np

    rng = np.random.RandomState(SERVE27_SEED)
    prompts = [rng.randint(0, vocab, size=n).astype(np.int32) for n in SERVE27_LENS]
    positions = [sorted(set(rng.choice(n - 1, SERVE27_POSITIONS - 1, replace=False).tolist())
                        | {n - 1}) for n in SERVE27_LENS]
    return prompts, positions


def serve27_run(torch, dev, cfg, params, shd, prompts) -> dict:
    """The requests through ``ActorServer`` (``shd``; the parameters cut by
    ``shard_params`` where it is on) after one warm-up request → each
    request's tokens, the flash launches, the seconds."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.serve import ActorServeConfig, ActorServer

    scfg = ActorServeConfig(**SERVE27)
    server = ActorServer(cfg, params, scfg, shd, device=dev)
    server.submit(prompts[0], 2)
    server.drain(timeout=600)
    torch.cuda.synchronize()
    warm = server.stats()["admissions"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [server.submit(p) for p in prompts]
    server.drain(timeout=600)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _flash_counts(ops, fa)
    st = server.stats()
    return {"tokens": [h.result(0).tokens for h in handles], "launches": counts,
            "seconds": secs, "admissions": st["admissions"] - warm, "decode_steps": st["steps"],
            "server": server}


def serve27_prefills(torch, dev, cfg, params, shd, prompts, positions,
                     decode: bool = True) -> dict:
    """Each prompt's prefill (batch 1) and, with ``decode``, one decode step
    after it: the logits at the prompt's positions (bf16, on the host), and
    fingerprints of the whole logits, the K/V cache and the decode logits."""
    from repro_torch.models import backbone

    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    rows, prints = [], []
    with torch.no_grad():
        for p, pos in zip(prompts, positions):
            tokens = torch.from_numpy(p).to(dev).long()[None]
            logits, cache = backbone.prefill(cfg, params, tokens, SERVE27["max_len"], shd=shd)
            lf = full(logits)[0]
            rows.append(lf[pos].cpu())
            if decode:
                tok = torch.argmax(lf[-1]).reshape(1, 1)
                lg = full(backbone.decode_step(cfg, params, cache, tok, shd=shd)[0])
                prints.append(fingerprints(torch, {"logits": lf, "k": full(cache["k"]),
                                                   "v": full(cache["v"]), "decode": lg}))
            del logits, cache, lf
    return {"logits": rows, "prints": prints}


def _serve27_rank(rank: int, device: str) -> dict:
    """27(b) on one of two gloo ranks sharing the card: InternLM2-1.8B at
    full width and depth (bf16, flash) drawn from SERVE27_SEED, cut by
    ``shard_params`` on a 1×2 (data, model) mesh and served through
    ``ActorServer(shd)``: the tokens, the flash launches (each rank's 8 of the
    16 heads), the server's cache pieces against ``tree_device_bytes``, one
    more decode step's wall time, collectives and host copies (the step
    runs every slot, busy or not), and the prefill logits."""
    import dataclasses as dc
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded
    from repro_torch.launch import specs as S
    from repro_torch.models import backbone
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    shd = meshlib.sharding_config(False)
    cfg = dc.replace(get_config("internlm2_1_8b"), attn_impl="flash")
    dm = meshlib.to_device_mesh(meshlib.small_mesh(1, 2), dev.type)
    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SERVE27_SEED))
    sharded.shard_params(cfg, shd, params, dm)
    gc.collect()
    torch.cuda.empty_cache()
    prompts, positions = serve27_inputs(cfg.vocab_size)
    out = serve27_run(torch, dev, cfg, params, shd, prompts)
    # the server's slot cache: this rank's pieces against tree_device_bytes,
    # one more decode step of its 8 slots (the last requests' caches, the
    # slots released) timed, its collectives and host copies
    server = out.pop("server")
    eng, state = server.engine, server.scheduler.state
    leaves = {k: v for k, v in S.flat_leaves(state.cache).items() if k != "pos"}
    held = sum(L.local(t).numel() * L.local(t).element_size() for t in leaves.values())
    want = S.tree_device_bytes(leaves, S.flat_leaves(S.cache_specs(cfg, shd, state.cache)), dm)
    full_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    torch.cuda.synchronize()
    meshlib.HOST_COPIES["all_gather_into_tensor"] = 0
    with collective_traffic(torch) as traffic:
        t0 = time.perf_counter()
        eng.step(params, state)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    out.update(cache_held=held, cache_want=want, cache_full=full_bytes, decode_step_s=step_s,
               decode_collectives=traffic.ops, decode_host_copies=dict(meshlib.HOST_COPIES))
    del server, eng, state, leaves
    gc.collect()
    n = SERVE27_LOGIT_PROMPTS
    out.update(serve27_prefills(torch, dev, cfg, params, shd, prompts[:n], positions[:n],
                                decode=False))
    if rank:
        del out["logits"]                       # the same whole logits on both ranks
    return out


def _serve27_one_by_one(torch, dev, card: str) -> dict:
    """27(a): InternLM2-1.8B at full width and depth (bf16, flash) served
    unsharded, its prefill logits beside the f32 model's, then the same
    weights cut onto a 1×1 mesh over NCCL (world 1 in this process) and
    served through ``ActorServer(shd)``: tokens, prefill and decode logits
    and the cache bit for bit."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharded
    from repro_torch.models import backbone
    from repro_torch.models.config import NO_SHARDING

    cfg = dataclasses.replace(get_config("internlm2_1_8b"), attn_impl="flash")
    prompts, positions = serve27_inputs(cfg.vocab_size)
    params = backbone.init_params(cfg, torch.Generator(device=dev).manual_seed(SERVE27_SEED))
    res = {"unsharded": serve27_run(torch, dev, cfg, params, NO_SHARDING, prompts)}
    del res["unsharded"]["server"]
    res["unsharded"].update(serve27_prefills(torch, dev, cfg, params, NO_SHARDING, prompts,
                                             positions))
    # the unsharded decode's top-2 margins along the served tokens (teacher
    # forced, one prompt at a time): how near a tie each pick was
    margins = []
    with torch.no_grad():
        for p, toks in zip(prompts, res["unsharded"]["tokens"]):
            logits, cache = backbone.prefill(cfg, params, torch.from_numpy(p).to(dev).long()[None],
                                             SERVE27["max_len"])
            last, row = logits[0, -1], []
            for t in toks:
                top2 = torch.topk(last.float(), 2).values
                row.append((float(top2[0] - top2[1]), float(top2[0])))
                last = backbone.decode_step(cfg, params, cache,
                                            torch.tensor([[t]], device=dev))[0][0, -1]
            margins.append(row)
            del logits, cache
    res["margins"] = margins
    # the f32 model on the same weights (naive attention, TF32 off)
    exact_cfg = dataclasses.replace(cfg, attn_impl="naive", dtype="float32")
    exact = backbone.Backbone(exact_cfg, dev)
    with torch.no_grad():
        for a, b in zip(exact.parameters(), params.parameters(), strict=True):
            a.copy_(b)
    res["f32_logits"] = serve27_prefills(torch, dev, exact_cfg, exact, NO_SHARDING, prompts,
                                         positions)["logits"]
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
                            world_size=1)
    try:
        shd = meshlib.sharding_config(False)
        dm = meshlib.to_device_mesh(meshlib.small_mesh(1, 1), dev.type)
        sharded.shard_params(cfg, shd, params, dm)
        gc.collect()
        torch.cuda.empty_cache()
        res["sharded"] = serve27_run(torch, dev, cfg, params, shd, prompts)
        del res["sharded"]["server"]
        res["sharded"].update(serve27_prefills(torch, dev, cfg, params, shd, prompts, positions))
    finally:
        dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dryrun27_start(out_dir: str):
    """27(c)'s dry run, started early in a process of its own (its fake
    process group is that process's): ``launch.dryrun`` on DRYRUN27_ARCH's
    cells at 16×16, its output to a file.  It runs on the host's cores
    beside the card's phases, which are bound by one core each."""
    import tempfile

    log = tempfile.NamedTemporaryFile("w+", prefix="chip_smoke_dryrun_", suffix=".log",
                                      delete=False)
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN27_ARCH,
           "--out", out_dir, "--force"]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(HERE))
    return proc, log, time.perf_counter()


def dryrun27_check(proc, log, t_start: float, out_dir: str, card: str) -> dict:
    """27(c): the dry run's exit code and each cell's record: every
    DRYRUN27_SHAPES cell ``ok`` with finite terms."""
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t_start
    log.seek(0)
    text = log.read()
    log.close()
    os.unlink(log.name)
    check(rc == 0, f"27(c) the dry run exited {rc}:\n{text[-3000:]}")
    cells = {}
    for shape in DRYRUN27_SHAPES:
        path = Path(out_dir) / f"{DRYRUN27_ARCH}_{shape}_pod1.json"
        check(path.exists(), f"27(c) no record for {shape}:\n{text[-2000:]}")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok", f"27(c) {shape}: {rec['status']} {rec.get('error')}")
        terms = {k: rec[k] for k in ("t_compute", "t_memory", "t_collective")}
        check(all(math.isfinite(v) and v >= 0 for v in terms.values())
              and rec["t_compute"] > 0 and rec["t_memory"] > 0,
              f"27(c) {shape}: terms {terms}")
        cells[shape] = {**terms, "dominant": rec["dominant"], "total_s": rec["total_s"],
                        "state_bytes_per_device": rec["state_bytes_per_device"],
                        "bytes_unfused_per_device": rec["bytes_unfused_per_device"],
                        "collective_bytes_per_device": rec["collective_bytes_per_device"],
                        "flops_global": rec["flops_global"], "collectives": rec["collectives"]}
        print(f"[dryrun] {DRYRUN27_ARCH} {shape} at 16x16 on a fake group of 256 ranks "
              f"(meta device; computed from shapes, H100 SXM datasheet constants): "
              f"t_compute {terms['t_compute']:.6g} s, t_memory {terms['t_memory']:.6g} s "
              f"(bytes_unfused {rec['bytes_unfused_per_device']:.6g} B a device), "
              f"t_collective {terms['t_collective']:.6g} s, dominant {rec['dominant']}; state "
              f"{rec['state_bytes_per_device']:,.0f} B a device; the cell took "
              f"{rec['total_s']} s", flush=True)
    print(f"[dryrun] launch.dryrun --arch {DRYRUN27_ARCH} in {secs:.1f} s (its own process, "
          f"beside phases 21-27) | {card}", flush=True)
    return {"cells": cells, "seconds": secs}


def sharded_serve_phase(torch, dev, card: str, dryrun=None, ranks=None) -> dict:
    """Phase 27: serving on a mesh of ranks — (a) a 1×1 mesh over NCCL bit
    for bit against the unsharded server; (b) a 1×2 mesh of two gloo ranks
    sharing the card, held to the f32 model and the unsharded server
    (``ranks``: what phase 26's ranks served, or None to spawn them here);
    (c) the dry run's InternLM2-1.8B cells at 16×16 (``dryrun``: the process
    ``dryrun27_start`` began, or None to run it here)."""
    import gc
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as meshlib

    t_phase = time.perf_counter()
    took = {}
    layers = get_config("internlm2_1_8b").num_layers
    n_req = len(SERVE27_LENS)
    want_flash = {fa.SM90_NAME: layers * n_req, fa.DQ_SM90_NAME: 0, fa.DKV_SM90_NAME: 0,
                  fa.NAME: 0, fa.DQ_NAME: 0, fa.DKV_NAME: 0}
    empty_card(torch, dev, "27")
    a = _serve27_one_by_one(torch, dev, card)
    took["a"] = time.perf_counter() - t_phase
    u, s1 = a["unsharded"], a["sharded"]
    check(u["admissions"] == s1["admissions"] == n_req, f"27(a) admissions {u['admissions']}, "
          f"{s1['admissions']}")
    check(u["launches"] == s1["launches"] == want_flash,
          f"27(a) flash launches unsharded {u['launches']}, 1x1 {s1['launches']}, expected "
          f"{want_flash} ({layers} a prefill)")
    check(s1["tokens"] == u["tokens"], f"27(a) the 1x1 server's tokens differ: "
          f"{s1['tokens']} against {u['tokens']}")
    differ = [(i, k) for i, (x, y) in enumerate(zip(s1["prints"], u["prints"]))
              for k in x if x[k] != y[k]]
    check(not differ, f"27(a) 1x1 prefill/decode logits or cache not bit for bit: {differ}")
    print(f"[sharded serve a] internlm2-1.8b at full width and depth (bf16, flash) through "
          f"ActorServer(shd) on a 1x1 mesh over nccl: {n_req} requests of {SERVE27_LENS} "
          f"tokens x {SERVE27['max_new_tokens']} new, the same tokens as the unsharded server; "
          f"each prompt's prefill logits, K/V cache and next decode logits bit for bit; "
          f"{fa.SM90_NAME} {s1['launches'][fa.SM90_NAME]} = {layers} x {n_req} prefills on "
          f"both; served in {s1['seconds']:.2f} s (unsharded {u['seconds']:.2f} s) | {card}",
          flush=True)

    t0 = time.perf_counter()
    if ranks is None:
        ranks = meshlib.spawn(_serve27_rank, 2, str(dev), backend="gloo", device=str(dev),
                              timeout_s=900)
    took["b"] = time.perf_counter() - t0
    b = ranks[0]
    check(ranks[1]["tokens"] == b["tokens"], "27(b) the two ranks answered differently")
    for rank, r in enumerate(ranks):
        check(r["admissions"] == n_req and r["launches"] == want_flash,
              f"27(b) rank {rank}: admissions {r['admissions']}, flash launches "
              f"{r['launches']}, expected {want_flash}")
        check(r["cache_held"] == r["cache_want"] and r["cache_held"] * 2 == r["cache_full"],
              f"27(b) rank {rank}: cache pieces {r['cache_held']:,} B against "
              f"tree_device_bytes {r['cache_want']:,.0f} (whole {r['cache_full']:,})")
    sums = {"sx": [0.0, 0.0], "ux": [0.0, 0.0]}
    worst = 0.0
    for ls, lu, lx in zip(b["logits"], u["logits"], a["f32_logits"]):
        for key, x in (("sx", ls), ("ux", lu)):
            sums[key] = [v + w for v, w in zip(sums[key], l2_sums(x, lx))]
        worst = max(worst, float((ls.float() - lu.float()).abs().max()))
    rel = {k: math.sqrt(num / den) for k, (num, den) in sums.items()}
    check(rel["sx"] <= 1.1 * rel["ux"], f"27(b) the 1x2 prefill logits are {rel['sx']:.4g} "
          f"relative l2 from the f32 model, the unsharded bf16 ones {rel['ux']:.4g}: the mesh "
          "adds error")
    # the tokens: equal but where the unsharded pick was a near tie (a top-2
    # gap within four bf16 ulps of the top logit); the rest of such a
    # request is not compared
    departures = []
    for i, (got, want, gaps) in enumerate(zip(b["tokens"], u["tokens"], a["margins"])):
        for t, (x, y, (gap, top)) in enumerate(zip(got, want, gaps)):
            if x != y:
                ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
                check(gap <= 4 * ulp, f"27(b) request {i} token {t}: {x} against the "
                      f"unsharded {y} at a top-2 gap {gap:.4g} > 4 bf16 ulps ({4 * ulp:.3g})")
                departures.append((i, t, round(gap, 6)))
                break
    print(f"[sharded serve b] internlm2-1.8b on a 1x2 (data x model) mesh of two gloo ranks on "
          f"the card (phase 26's; each rank 8 of the 16 heads): prefill logits of the "
          f"{SERVE27_LOGIT_PROMPTS} lengths {rel['sx']:.4g} relative l2 "
          f"from the f32 model, the unsharded bf16 {rel['ux']:.4g} (<= 1.1x), largest "
          f"difference from the unsharded logits {worst:.4g}; tokens as the unsharded server's "
          f"but {len(departures)} near-tie departures {departures}, the same on both ranks; "
          f"{fa.SM90_NAME} {b['launches'][fa.SM90_NAME]} a rank; cache pieces "
          f"{b['cache_held']:,} B a rank = tree_device_bytes (half the whole); served in "
          f"{b['seconds']:.2f} s; one decode step of {SERVE27['slots']} slots "
          f"{b['decode_step_s'] * 1e3:.1f} ms wall, its collectives {b['decode_collectives']} "
          f"(calls, input bytes), host-staged all-gathers {b['decode_host_copies']} | {card}",
          flush=True)
    rows = [{k: r[k] for k in ("launches", "seconds", "cache_held", "cache_want",
                               "decode_step_s", "decode_collectives", "decode_host_copies")}
            for r in ranks]
    del ranks, b
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if dryrun is None:
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        dryrun = (*dryrun27_start(out_dir), out_dir)
    proc, log, t_start, out_dir = dryrun
    c = dryrun27_check(proc, log, t_start, out_dir, card)
    took["c (waited)"] = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    print(f"[sharded serve] phase 27 in {seconds:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")", flush=True)
    return {"a": {"unsharded": {k: u[k] for k in ("launches", "seconds", "decode_steps")},
                  "sharded": {k: s1[k] for k in ("launches", "seconds", "decode_steps")}},
            "b": rows, "c": c, "seconds": seconds, "rel_l2_from_f32": rel,
            "departures": departures}


# -- phase 28: the port's lint on the card ---------------------------------------

LINT_CALLS = 3          # witnessed calls of each step program


def _cartpole_executor(torch, dev, kind: str):
    """The main path's CartPole executor (8 envs, DQN (4, 256, 256, 2), K=128,
    batch 64, ε 0.2) with a short warmup, stepped past it, → (executor,
    state)."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec, _, _ = env_fn(1)
    replay = PrioritizedReplay(ReplayConfig(capacity=20_000, fanout=128),
                               transition_example(spec), device=dev)
    cfg = LoopConfig(batch_size=64, warmup=64, epsilon=0.2)
    agent = make_dqn(spec, DQNConfig())
    ex = (AsyncExecutor(agent, replay, env_fn, cfg, n_envs=8, publish_interval=2, device=dev)
          if kind == "async" else FusedExecutor(agent, replay, env_fn, cfg, n_envs=8,
                                                device=dev))
    state, _ = ex.run(ex.init(SEED), 12)
    check(state.learn_steps > 0, f"28: the {kind} loop has not learned after 12 iterations")
    return ex, state


def _stepper(step, state):
    """A call that advances ``state`` by one ``step``."""
    box = [state]

    def call():
        box[0], metrics = step(box[0])
        return metrics
    return call


def _lint_programs(torch, dev) -> dict:
    """Phase 28(b)'s step programs on the card → {name: (call, calls)}."""
    import numpy as np

    from repro_torch.agents import ddpg, sac, td3, token_dqn
    from repro_torch.configs import get_config
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs import token_mdp
    from repro_torch.envs.classic import make_vec
    from repro_torch.launch import train as ltrain
    from repro_torch.models import backbone
    from repro_torch.quickstart import transition_example
    from repro_torch.serve.buckets import BucketSpec
    from repro_torch.serve.engine import DecodeEngine

    from repro_torch.kernels import ops
    from repro_torch.models import xlstm

    progs = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    # one iteration a call, through the executor's run_chunk
    fused, f_state = _cartpole_executor(torch, dev, "fused")
    progs["loop step, fused executor (CartPole)"] = (
        _stepper(lambda s: fused.run_chunk(s, 1), f_state), LINT_CALLS)
    asy, a_state = _cartpole_executor(torch, dev, "async")
    progs["loop step, async executor (CartPole)"] = (
        _stepper(lambda s: asy.run_chunk(s, 1), a_state), LINT_CALLS)

    # replay sample → priority write → flush in the three arms
    spec_env, _, _ = make_vec("cartpole", 1)
    example = transition_example(spec_env)
    items = {k: torch.zeros((512,) + tuple(v.shape), dtype=v.dtype, device=dev)
             for k, v in example.items()}
    for arm, fused_arm, lazy in (("lazy", False, True), ("eager", False, False),
                                 ("fused", True, True)):
        replay = PrioritizedReplay(ReplayConfig(capacity=50_000, fanout=128,
                                                fused_sample_gather=fused_arm),
                                   example, device=dev)
        rs = replay.flush(replay.append(replay.init(), items, lazy=True))
        td = torch.rand((64,), generator=gen, device=dev)

        def chain(replay=replay, box=[rs], lazy=lazy, td=td):
            idx, got, w = replay.sample(box[0], gen, 64)
            box[0] = replay.flush(replay.update_priorities(box[0], idx, td, lazy=lazy))
            return got, w
        progs[f"replay sample, update, flush ({arm} arm)"] = (chain, LINT_CALLS)

    # the one-leaf gather (#2) on the last arm's storage
    g_idx = torch.randint(0, 512, (64,), generator=gen, device=dev)
    g_leaf = rs.storage["obs"]
    progs["one-leaf gather"] = (lambda: ops.prioritized_gather(g_leaf, g_idx), LINT_CALLS)

    # one learn call of each CartPole and Pendulum agent on a sampled batch
    fused_batch = fused.replay.sample(fused.replay.flush(f_state.replay), gen, 64)
    progs["DQN learn"] = (lambda: fused.agent.learn(f_state.agent, fused_batch[1],
                                                     fused_batch[2]), LINT_CALLS)
    p_spec, _, _ = make_vec("pendulum", 1)
    p_ex = transition_example(p_spec)
    p_batch = {k: torch.rand((64,) + tuple(v.shape), generator=gen, device=dev).to(v.dtype)
               for k, v in p_ex.items()}
    w = torch.ones((64,), device=dev)
    for name, agent in (("DDPG", ddpg.make_ddpg(p_spec, ddpg.DDPGConfig())),
                        ("TD3", td3.make_td3(p_spec, td3.TD3Config())),
                        ("SAC", sac.make_sac(p_spec, sac.SACConfig()))):
        a_st = agent.init(torch.Generator(device=dev).manual_seed(SEED))
        progs[f"{name} learn"] = (lambda agent=agent, a_st=a_st: agent.learn(a_st, p_batch, w),
                                  LINT_CALLS)

    # the token-DQN train step at InternLM2's SMOKE width, f32, flash (#5b-#7b)
    t_cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), attn_impl="flash",
                                dtype="float32")
    tcfg = token_dqn.TokenDQNConfig()
    t_state = token_dqn.init_train_state(t_cfg, tcfg, torch.Generator(device=dev).manual_seed(
        SHARD_SEED))
    t_batch = shard_token_batch(torch, t_cfg, dev)
    progs["token-DQN train_step (InternLM2 SMOKE, f32, flash)"] = (
        lambda: token_dqn.train_step(t_cfg, token_dqn.NO_SHARDING, tcfg, t_state, t_batch)[1],
        2)
    # the token trainer's collect at the same width (16 steps of 8 actors)
    gens = {k: torch.Generator(device=dev).manual_seed(SEED + i)
            for i, k in enumerate(("action", "epsilon", "env"))}
    reset, step_env, _ = token_mdp.make(token_mdp.TokenMDPSpec(vocab=t_cfg.vocab_size),
                                        torch.Generator(device=dev).manual_seed(SEED), 8)
    env_state, obs = reset(torch.Generator(device=dev).manual_seed(SEED + 1))
    progs["token trainer collect (InternLM2 SMOKE, 16 steps)"] = (
        lambda: ltrain.collect(t_cfg, t_state.params, step_env, env_state, obs, 16, gens), 1)

    # the actor server's engine at Granite-8B's SMOKE width
    s_cfg = get_config("granite_8b", smoke=True)
    s_params = backbone.init_params(s_cfg, torch.Generator(device=dev).manual_seed(SEED + 5))
    eng = DecodeEngine(s_cfg, slots=2, max_len=16, buckets=BucketSpec((8,)), device=dev)
    e_state = eng.init_state()
    prompt = np.arange(5, dtype=np.int32) + 3
    primed = eng.prime(s_params, prompt)
    progs["engine prime (Granite-8B SMOKE)"] = (lambda: eng.prime(s_params, prompt), LINT_CALLS)
    progs["engine insert"] = (lambda: eng.insert(e_state, 0, primed[1], primed[0]), LINT_CALLS)

    def decode(box=[e_state]):
        actions, box[0] = eng.step(s_params, box[0])
        return actions
    progs["engine decode step"] = (decode, LINT_CALLS)
    progs["engine release"] = (lambda: eng.release(e_state, 1), LINT_CALLS)
    # the recurrent families' forward at SMOKE width (the sLSTM's scalars),
    # xLSTM's also with the chunkwise mLSTM (64 tokens: one MLSTM_CHUNK)
    for arch, chunked in (("hymba_1_5b", False), ("xlstm_125m", False),
                          ("xlstm_125m", True)):
        r_cfg = get_config(arch, smoke=True)
        if chunked:
            r_cfg = dataclasses.replace(r_cfg, mlstm_chunked=True)
        r_params = backbone.init_params(r_cfg, torch.Generator(device=dev).manual_seed(SEED))
        toks = torch.randint(0, r_cfg.vocab_size, (2, 64), generator=gen, device=dev)

        def fwd(r_cfg=r_cfg, r_params=r_params, toks=toks):
            with torch.no_grad():
                return backbone.forward(r_cfg, r_params, toks)
        progs[f"forward ({r_cfg.name}{', chunked mLSTM' if chunked else ''})"] = (fwd, 1)
    # the xLSTM cells' prefill state (no caller in the port yet: driven
    # here on the first mLSTM and the first sLSTM block)
    blocks = {kind: block[kind] for block in reversed(r_params.blocks)
              for kind in ("mlstm", "slstm") if kind in block}
    x_in = torch.randn((2, 64, r_cfg.d_model), generator=gen, device=dev)

    def prefill_states(r_cfg=r_cfg):
        with torch.no_grad():
            return (xlstm.mlstm_prefill_state(r_cfg, blocks["mlstm"],
                                              x_in.to(blocks["mlstm"].wq.dtype)),
                    xlstm.slstm_prefill_state(r_cfg, blocks["slstm"],
                                              x_in.to(blocks["slstm"].w_out.dtype)))
    progs[f"mLSTM and sLSTM prefill state ({r_cfg.name})"] = (prefill_states, 1)
    return progs


# registry entries phase 28(b) does not run, and where their card runs are
LINT_NOT_WITNESSED = {
    "launch/multiprocess.py": "a gang process of its own (phases 19, 20)",
    "runtime/executors.py::ShardedExecutor": "the ranks of phase 18",
    "launch/train.py::_make_param_averager": "the wall-clock gang's ranks (phase 20(e))",
    "service/": "the replay service's gang and executor (phase 19)",
    "models/backbone.py::_whisper_forward": "Whisper-medium at full width (phase 25)",
    "models/layers.py::_attn_chunked_q": "the chunked-query attention, which no phase's "
                                         "config selects",
}


def lint_phase(torch, dev, card: str) -> dict:
    """Phase 28: the port's lint (a), its host-sync rule against the card's
    sync-debug mode (b), a seeded sync both ways (c), the in-place table
    against the card's storage (d)."""
    import importlib.util

    from repro_torch.analysis import donation, retrace
    from repro_torch.analysis.cli import all_findings
    from repro_torch.kernels import ops
    from repro_torch.launch import lint_witness as lw

    t0 = time.perf_counter()
    res = {}
    # (a) the lint, as a user runs it, beside (b)'s set-up
    out_dir = HERE / "build"
    out_dir.mkdir(exist_ok=True)
    report = out_dir / "repro_lint_torch.json"
    proc = subprocess.Popen([sys.executable, str(HERE / "tools" / "repro_lint_torch.py"),
                             "--check", "--report", str(report)], cwd=str(HERE),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        progs = _lint_programs(torch, dev)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"28(a) tools/repro_lint_torch.py --check exited "
          f"{proc.returncode}: {out[-4000:]}")
    flagged = {}
    for f in json.loads(report.read_text())["findings"]:
        flagged[f["rule"]] = flagged.get(f["rule"], 0) + 1
    items = lw.waivers_by_item()
    res["a"] = {"flagged": flagged, "waivers_by_item": items}
    print(f"[lint a] tools/repro_lint_torch.py --check: exit 0, "
          f"{out.strip().splitlines()[-1]}; findings by rule {flagged}; waivers by rule and "
          f"ROADMAP item {items} | {card}", flush=True)

    # (b) every step program's syncs under the card's sync-debug mode
    index = lw.LintIndex()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    witnessed = {}
    for name, (call, calls) in progs.items():
        witnessed[name] = lw.witness(index, call, calls)
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    res["b"] = {"programs": witnessed, "launches": launches}
    for name, w in witnessed.items():
        sites = "; ".join(f"{s['file']}:{s['line']} {s['function']} {s['kind']}"
                          f"{' ' + s['rule'] if s['rule'] else ''}"
                          f"{' (waived)' if s['waived'] else ''}"
                          f"{' (outside the scope)' if s['kind'] == 'missed' and not s['scoped'] else ''}"
                          f" x{s['count']}" for s in w["sites"]) or "none"
        print(f"[lint b] {name}: {w['per_call']:g} host syncs a call ({w['syncs']} in "
              f"{w['calls']} calls), missed={w['missed']}; sites: {sites}; registry entries "
              f"reached: {sorted(w['reached'])} | {card}", flush=True)
    missed = sum(w["missed"] for w in witnessed.values())
    print(f"[lint b] missed={missed} over {len(witnessed)} programs; launches {launches} "
          f"| {card}", flush=True)
    check(missed == 0, "28(b) the card synchronized at lines of the port that the lint does "
          "not flag: " + json.dumps(
              {n: [s for s in w["sites"] if s["kind"] == "missed"]
               for n, w in witnessed.items() if w["missed"]}))
    for name in ("loop step, fused executor (CartPole)", "loop step, async executor (CartPole)"):
        check(witnessed[name]["syncs"] == 0,
              f"28(b) the {name} synchronized: {witnessed[name]['sites']}")
    for kernel in ("sumtree_sample", "gather", "sample_gather", "sumtree_update",
                   "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
        check(launches.get(kernel, 0) > 0,
              f"28(b) the witnessed programs never launched {kernel}: {launches}")
    # every registry entry is reached by a witnessed program, or its card
    # runs are elsewhere
    reached = {ref for w in witnessed.values() for ref in w["reached"]}
    unreached = []
    for prog in retrace.REGISTRY:
        why = next((r for k, r in LINT_NOT_WITNESSED.items() if prog.ref.startswith(k)), None)
        if why and prog.ref not in reached:
            print(f"[lint b] not witnessed here: {prog.ref} -> {', '.join(prog.port)}: {why}",
                  flush=True)
        elif prog.ref not in reached:
            unreached.append(prog.ref)
    res["b"]["reached"] = sorted(reached)
    print(f"[lint b] {len(reached)} of {len(retrace.REGISTRY)} registry entries reached by the "
          f"witnessed programs | {card}", flush=True)
    check(not unreached, f"28(b) registry entries that no witnessed program reached and "
          f"LINT_NOT_WITNESSED does not name: {unreached}")

    # (c) a seeded sync: the DQN learn with .item() of its loss, caught both ways
    src = (HERE / "src" / "repro_torch" / "agents" / "dqn.py").read_text()
    before = "        grads, aux = grads_fn(state, batch, is_w)\n"
    check(before in src, "28(c) agents/dqn.py's learn has moved: update the seeded sync")
    seeded_dir = HERE / "build" / "lint_seeded"
    seeded_dir.mkdir(parents=True, exist_ok=True)
    seeded = seeded_dir / "dqn.py"
    seeded.write_text(src.replace(before, before + "        aux['loss'].item()\n", 1))
    seed_line = src[:src.index(before)].count("\n") + 2
    spec_ = importlib.util.spec_from_file_location("lint_seeded_dqn", seeded)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[spec_.name] = mod       # its dataclasses look their module up
    spec_.loader.exec_module(mod)
    from repro_torch.envs.classic import make_vec

    c_spec, _, _ = make_vec("cartpole", 1)
    s_agent = mod.make_dqn(c_spec, mod.DQNConfig())
    s_state = s_agent.init(torch.Generator(device=dev).manual_seed(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    s_batch = ({"obs": torch.rand((64, 4), generator=g, device=dev),
                "action": torch.randint(0, 2, (64,), generator=g, device=dev,
                                        dtype=torch.int32),
                "reward": torch.rand((64,), generator=g, device=dev),
                "next_obs": torch.rand((64, 4), generator=g, device=dev),
                "done": torch.zeros((64,), device=dev)}, torch.ones((64,), device=dev))
    s_index = lw.LintIndex(overrides={str(seeded): "agents/dqn.py"})
    sw = lw.witness(s_index, lambda: s_agent.learn(s_state, *s_batch), 1)
    at_line = [s for s in sw["sites"] if s["file"] == "agents/dqn.py"
               and s["line"] == seed_line]
    lint_lines = [f.line for f in all_findings(str(seeded), "src/repro_torch/agents/dqn.py")[0]
                  if f.rule == "R404"]
    res["c"] = {"line": seed_line, "witness": sw["sites"], "lint_lines": lint_lines}
    check(at_line and at_line[0]["kind"] == "finding" and at_line[0]["rule"] == "R404"
          and not at_line[0]["waived"] and seed_line in lint_lines,
          f"28(c) the seeded sync at agents/dqn.py:{seed_line}: witness {sw['sites']}, "
          f"the lint's R404 lines {lint_lines}")
    print(f"[lint c] a seeded .item() in the DQN learn (agents/dqn.py:{seed_line}): the card "
          f"synchronized there ({at_line[0]['count']} sync) and the lint flags R404 at that "
          f"line of the patched source | {card}", flush=True)

    # (d) every in-place table entry returns its argument's own storage
    aliases = {}
    cases = lw.inplace_cases(dev)
    with lw.world_one("gloo"):
        for entry, case in cases.items():
            aliases[f"{entry.module}::{entry.func}"] = bool(case())
    torch.cuda.synchronize()
    res["d"] = aliases
    entries = {f"{e.module}::{e.func}": e.site for e in donation.IN_PLACE}
    check(all(aliases.values()), f"28(d) in-place entries whose result does not share the "
          f"argument's storage: {[k for k, v in aliases.items() if not v]}")
    print(f"[lint d] {len(aliases)} in-place table entries on the card, each returning its "
          f"argument's own storage: {json.dumps({k: entries[k] for k in aliases})}; "
          f"no counterpart: {[n.site for n in donation.NO_COUNTERPART]} | {card}", flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"[lint] phase 28 in {res['seconds']:.1f} s | {card}", flush=True)
    return res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE / "src"))

    from repro_torch.core import sumtree
    from repro_torch.kernels import _build, ops, parity
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sumtree_update as kupdate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    secs = ops.build_all()
    print(f"[build] {len(ops.KERNELS)} kernels built in {secs:.1f} s (0 = already built)",
          flush=True)
    # the Hopper flash kernels' machine code: wgmma (HGMMA) and TMA loads (UTMALDG)
    for name in ("flash_attention_fwd_sm90", "flash_attention_dq_sm90",
                 "flash_attention_dkv_sm90"):
        lib = _build._lib_path(name)
        sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300)
        hgmma, utmaldg = sass.stdout.count("HGMMA"), sass.stdout.count("UTMALDG")
        print(f"[sass] {lib.name}: {hgmma} HGMMA and {utmaldg} UTMALDG instructions (cuobjdump "
              f"-sass)", flush=True)
        check(sass.returncode == 0 and hgmma > 0 and utmaldg > 0,
              f"no wgmma or no TMA load in {lib.name}'s SASS (cuobjdump rc {sass.returncode})")
        # ptxas -v of each instance (hd 128, 96, 64): registers, spills, and
        # whether it serialized a wgmma (C7512/C7513/C7518)
        log = _build.build_log(name)
        usage = [line.strip() for line in log.splitlines() if "spill" in line]
        serial = sorted(set(code for code in ("C7512", "C7513", "C7518") if code in log))
        print(f"[ptxas] {name}: {'; '.join(usage)}; wgmma serialized: "
              f"{', '.join(serial) or 'no'}", flush=True)
    # the backward pair of f32 and hd 16: warp-level tensor-core products
    # (HMMA) and asynchronous copies (LDGSTS)
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        lib = _build._lib_path(name)
        sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300)
        hmma, ldgsts = sass.stdout.count("HMMA"), sass.stdout.count("LDGSTS")
        usage = [line.strip() for line in _build.build_log(name).splitlines() if "spill" in line]
        print(f"[sass] {lib.name}: {hmma} HMMA and {ldgsts} LDGSTS instructions (cuobjdump "
              f"-sass); [ptxas] {'; '.join(usage)}", flush=True)
        check(sass.returncode == 0 and hmma > 0 and ldgsts > 0,
              f"no mma.sync or no cp.async in {lib.name}'s SASS (cuobjdump rc {sass.returncode})")

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"sumtree_sample": 0.0, "gather": 0.0, "sample_gather": 0.0,
           "sumtree_update": 0.0}

    clock("3 (parity)")
    # 3. parity: each kernel against its plain version on the card
    shapes = [("main path", 50_000, 128, 64), ("Nature DQN", 1_000_000, 128, 512),
              ("token replay", 8192, 128, 8), ("K=8", 100_000, 8, 512),
              ("K=256", 100_000, 256, 512), ("tiny tail", 10, 4, 64)]
    ties = {}
    for label, capacity, fanout, batch in shapes:
        spec, tree0 = replay_tree(torch, dev, gen, capacity, fanout)
        storage = replay_storage(torch, dev, gen, capacity, token=label == "token replay")
        reports = {65_536: [], batch: []}
        for tree in (tree0, bumped(spec, tree0)):
            # 1: sample — indices equal except under the fp-tie rule of
            # kernels/parity.py, at 65,536 draws and at the path's batch;
            # the first four draws are u → 1, the tail
            for draws in reports:
                u = torch.cat([torch.full((4,), 1.0 - 1e-7, device=dev),
                               torch.rand((draws - 4,), generator=gen, device=dev)])
                ki, kp = ops.sumtree_sample(spec, tree, u)
                pi, pp = sumtree.sample(spec, tree, u)
                torch.cuda.synchronize()
                rep = parity.sample_ties(spec, tree, u, ki, pi)
                check(rep.ok, f"sumtree_sample idx at {label}, {draws} draws: {rep}")
                reports[draws].append(rep)
                agree = ki == pi
                torch.testing.assert_close(kp[agree], pp[agree], rtol=1e-5, atol=0)
                err["sumtree_sample"] = max(err["sumtree_sample"],
                                            float((kp[agree] - pp[agree]).abs().max()))
                check(bool((ki[:4] <= capacity - 1).all()) and bool((kp[:4] > 0).all()),
                      f"tail draws did not clamp onto a live leaf at {label}")
            # the batch-sized draws of the last pass feed the gathers
            # 2: gather — bit-exact in every dtype, rank 1 to 3, one leaf a
            # launch and every leaf in one launch
            items = ops.gather_items(storage, ki)
            for name, buf in storage.items():
                got = ops.prioritized_gather(buf, ki)
                torch.testing.assert_close(got, buf[ki], rtol=0, atol=0)
                check(same_bytes(torch, items[name], buf[ki]),
                      f"gather_items of {name} at {label}")
            # 3: fused sample+gather ≡ split kernels
            fi, fp, items = ops.sumtree_sample_gather(spec, tree, u, storage)
            torch.testing.assert_close(fi, ki, rtol=0, atol=0)
            torch.testing.assert_close(fp, kp, rtol=0, atol=0)
            for name, buf in storage.items():
                torch.testing.assert_close(items[name], buf[ki], rtol=0, atol=0)
            # inf, NaN and int32 above 2^24 through all three, byte for byte
            odd = nonfinite_storage(torch, dev, gen, capacity, ki)
            fi, _, fused = ops.sumtree_sample_gather(spec, tree, u, odd)
            for via, got in (("gather", {k: ops.prioritized_gather(b, ki) for k, b in odd.items()}),
                             ("gather_items", ops.gather_items(odd, ki)), ("sample_gather", fused)):
                check(torch.equal(fi, ki) and all(same_bytes(torch, got[k], b[ki])
                                                  for k, b in odd.items()),
                      f"{via} of non-finite and int32 >= 2^24 rows at {label}")
            torch.cuda.synchronize()
        # 4: update — duplicates and unique; leaves bit for bit, each
        # interior level to its own scale (atomics reorder the sums)
        for unique in (False, True):
            if unique:
                idx = torch.randperm(capacity, generator=gen, device=dev)[:batch]
            else:
                idx = torch.randint(0, capacity, (batch,), generator=gen, device=dev)
                idx[: batch // 4] = idx[0]
            val = torch.rand(idx.shape, generator=gen, device=dev) * 3
            got = ops.sumtree_update(spec, tree0.clone(), idx, val, unique=unique)
            again = ops.sumtree_update(spec, tree0.clone(), idx, val, unique=unique)
            want = sumtree.update(spec, tree0.clone(), idx, val, unique=unique)
            torch.cuda.synchronize()
            problems = parity.tree_mismatch(spec, got, want)
            check(not problems, f"sumtree_update at {label} (unique={unique}): {problems}")
            check(sumtree.check_invariant(spec, got), f"update broke the tree at {label}")
            check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                  f"sumtree_update at {label}: a second call differs")
            err["sumtree_update"] = max(err["sumtree_update"],
                                        float((got - want).abs().max()))
        ties[label] = {str(d): {"flips": [r.flips for r in reps],
                                "allowed": [r.allowed for r in reps],
                                "max_dist_ulp": max(r.max_dist_ulp for r in reps)}
                       for d, reps in reports.items()}
        ties[label]["window_ulp"] = reports[batch][0].window_ulp
        flips = "; ".join(
            f"{d} draws: {'+'.join(str(r.flips) for r in reps)} flipped (at most "
            f"{reps[0].allowed} each), farthest {max(r.max_dist_ulp for r in reps):.3f} ulp"
            for d, reps in reports.items())
        print(f"[parity] {label}: capacity {capacity}, K={fanout}, B={batch}: "
              "sample/gather/gather_items/sample_gather/update agree (rows byte for byte, "
              "inf/NaN/int32 >= 2^24 rows too); sample indices on the plain "
              f"tree + the bumped tree, {flips} (window "
              f"{reports[batch][0].window_ulp:g} ulp(total))", flush=True)

    # the update past one CTA and the fused kernel's leaf tables, at the main
    # path's tree
    spec, tree0 = replay_tree(torch, dev, gen, 50_000, 128)
    for batch in UPDATE_BATCHES:
        idx = torch.randint(0, 50_000, (batch,), generator=gen, device=dev)
        # every fifth entry repeats an earlier one: duplicates across the
        # batch and across the chunks of 1,024
        rep = torch.arange(batch, device=dev)[4::5]
        idx[rep] = idx[torch.randint(0, batch, rep.shape, generator=gen, device=dev)]
        val = torch.rand((batch,), generator=gen, device=dev) * 3
        before = ops.launch_counts["sumtree_update"]
        got = ops.sumtree_update(spec, tree0.clone(), idx, val)
        launched = ops.launch_counts["sumtree_update"] - before
        again = ops.sumtree_update(spec, tree0.clone(), idx, val)
        want = sumtree.update(spec, tree0.clone(), idx, val)
        torch.cuda.synchronize()
        problems = parity.tree_mismatch(spec, got, want)
        check(not problems, f"sumtree_update at B={batch}: {problems}")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"sumtree_update at B={batch}: a second call differs")
        check(launched == -(-batch // kupdate.CHUNK),
              f"sumtree_update at B={batch}: {launched} launches")
        err["sumtree_update"] = max(err["sumtree_update"], float((got - want).abs().max()))
    print(f"[parity] update at 50,000/K=128, B = {', '.join(map(str, UPDATE_BATCHES))} "
          "(repeats across chunks): leaves bit for bit, interior under the level rule, a "
          f"second call bit for bit, ceil(B / {kupdate.CHUNK}) launches", flush=True)
    u = torch.cat([torch.full((4,), 1.0 - 1e-7, device=dev),
                   torch.rand((60,), generator=gen, device=dev)])
    si, sp = ops.sumtree_sample(spec, tree0, u)
    for table, storage in (("mixed widths, one leaf 4 bytes off", mixed_leaves(torch, dev, gen)),
                           ("16 leaves", sixteen_leaves(torch, dev, gen))):
        fi, fp, items = ops.sumtree_sample_gather(spec, tree0, u, storage)
        torch.cuda.synchronize()
        check(torch.equal(fi, si) and torch.equal(fp, sp),
              f"sample_gather on {table}: indices or priorities differ from the split descent")
        for name, buf in storage.items():
            check(same_bytes(torch, items[name], buf[si.clamp(0, buf.shape[0] - 1)]),
                  f"sample_gather on {table}: leaf {name}")
    print("[parity] sample_gather on a table of 1-, 4-, 12-, 16- and 1,024-byte rows with "
          "views 4, 2 and 1 bytes off alignment, and on 16 leaves: indices and priorities "
          "those of the split descent, rows byte for byte", flush=True)

    clock("4 (main path)")
    # 4. main path: the paper's system through the user entry points
    # the return passes 30 in the fifth chunk of 64 (the returns a chunk are
    # in the rate line: 33.0, then 130.6 and up); 1400 until the script's
    # time limit needed the time
    main_iters = 768
    ex, state, hist, secs, main_counts, _ = run_arm(torch, main_iters, fused=False, lazy=True)
    replay = ex.replay
    final = float(hist["mean_episode_return"][-1])
    print(f"[main path] {main_iters} iterations in {secs:.2f} s: "
          f"{state.env_steps / secs:,.1f} env-steps/s, "
          f"{state.learn_steps / secs:,.1f} learner calls/s, final return {final:.1f}, "
          f"launches {main_counts}", flush=True)
    check(final > 30.0, f"main path return {final} does not beat 30")
    check(main_counts.get("sumtree_sample", 0) > 0 and main_counts.get("gather", 0) > 0,
          f"the main path did not launch the sample and gather kernels: {main_counts}")
    check(main_counts.get("gather") == main_counts.get("sumtree_sample"),
          f"not one gather launch per learner call: {main_counts}")
    check(bool(torch.isfinite(hist["loss"]).all()), "non-finite loss on the main path")
    check(sumtree.check_invariant(replay.spec, replay.flush(state.replay).tree),
          "tree invariant broken after the main path")
    tensors = ([state.obs, state.episode_return, state.last_return,
                state.env_state.x, state.env_state.t, state.agent.step,
                state.agent.opt.count, state.replay.tree, state.replay.max_priority]
               + list(state.agent.params.parameters())
               + list(state.agent.target.parameters())
               + state.agent.opt.m + state.agent.opt.v
               + list(state.replay.storage.values()))
    check(all(t.device.type == "cuda" for t in tensors), "state left the GPU")
    main_rate = {"env_steps_per_s": state.env_steps / secs,
                 "learner_calls_per_s": state.learn_steps / secs,
                 "iterations": main_iters, "seconds": secs,
                 "returns_by_chunk": [round(float(x), 1) for x in hist["mean_episode_return"]]}

    # where the main path's time goes: a profiler window of steady iterations
    # (8 learner calls each), taken after the counted run
    state, main_rate["profile"] = profile_loop(torch, ex, state)
    print(profile_line("main path", main_rate["profile"]), flush=True)

    # 5. the other two arms; the launches the code predicts: one fused launch a
    # learner call; one update launch a learner call and two an iteration (the
    # insert's zeroing and its commit)
    arms = {}
    arm_iters = 100
    for arm, fused, lazy, kernel in (("fused", True, True, "sample_gather"),
                                     ("eager", False, False, "sumtree_update")):
        ex_a, st, h, s, counts, calls = run_arm(torch, arm_iters, fused=fused, lazy=lazy)
        want = calls["learner_calls"] + (0 if fused else 2 * arm_iters)
        op = "sample_gather" if fused else "update"
        check(counts.get(kernel, 0) == want == calls.get(op, 0),
              f"the {arm} arm launched {kernel} {counts.get(kernel, 0)} times for "
              f"{calls.get(op, 0)} {op} calls; the code predicts {want}: {counts}")
        check(bool(torch.isfinite(h["loss"]).all()), f"non-finite loss on the {arm} arm")
        arms[arm] = counts
        print(f"[{arm} arm] {arm_iters} iterations in {s:.2f} s: {st.env_steps / s:,.1f} "
              f"env-steps/s, {st.learn_steps / s:,.1f} learner calls/s, "
              f"launches {counts} ({want} predicted)", flush=True)
        del ex_a, st

    clock("6 (times)")
    # 6. times at the main path's shapes and at the Nature-DQN size
    def measure(capacity, batch, token=False):
        spec, tree = replay_tree(torch, dev, gen, capacity, 128)
        storage = {k: v for k, v in replay_storage(torch, dev, gen, capacity, token).items()
                   if k != "frames"}
        u = torch.rand((batch,), generator=gen, device=dev)
        idx, _ = ops.sumtree_sample(spec, tree, u)
        obs = next(iter(storage.values()))     # the gather's timed rows: obs or tokens
        upd_idx = torch.randint(0, capacity, (batch,), generator=gen, device=dev)
        upd_val = torch.rand((batch,), generator=gen, device=dev)
        upd_tree, plain_tree = tree.clone(), tree.clone()
        row_sum = sum(v[0].numel() * v.element_size() for v in storage.values())
        n_rows = int(torch.unique(idx).numel())
        sample_bytes = (4 + batch * 4 + rows_touched(torch, spec, idx) * spec.fanout * 4
                        + batch * 12)
        sample_ops = batch * spec.height * spec.fanout
        ob = obs[0].numel() * obs.element_size()
        # the library yardstick of the descent: one searchsorted on the
        # leaves' CDF, both built outside the timed call
        cdf = torch.cumsum(sumtree.leaves(spec, tree), 0)
        cdf[-1] = float("inf")
        pos = torch.clamp(u, 1e-12, 1.0 - 1e-7) * tree[0]
        calls = {
            "sumtree_sample": (lambda: ops.sumtree_sample(spec, tree, u),
                               lambda: sumtree.sample(spec, tree, u),
                               lambda: torch.searchsorted(cdf, pos),
                               bound(sample_bytes, sample_ops)),
            "gather": (lambda: ops.prioritized_gather(obs, idx),
                       lambda: obs[idx.clamp(0, capacity - 1)],
                       lambda: torch.index_select(obs, 0, idx),
                       bound(batch * 8 + n_rows * ob + batch * ob, 0)),
            "sample_gather": (
                lambda: ops.sumtree_sample_gather(spec, tree, u, storage),
                lambda: (lambda i: [b[i] for b in storage.values()])(
                    sumtree.sample(spec, tree, u)[0]), None,
                bound(sample_bytes + n_rows * row_sum + batch * row_sum, sample_ops)),
            "sumtree_update": (
                lambda: kupdate.sumtree_update_cuda(spec, upd_tree, upd_idx, upd_val),
                lambda: sumtree.update(spec, plain_tree, upd_idx, upd_val), None,
                bound(batch * 12 + nodes_touched(torch, spec, upd_idx) * 8,
                      batch * spec.height)),
        }
        out = {}
        for name, (kern, plain, lib, (bound_ms, bound_by)) in calls.items():
            out[name] = {"ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
                         "library_ms": device_ms(torch, lib) if lib else None,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "call_ms": call_ms(torch, kern)}
        # the public wrapper, as the replay calls it
        out["sumtree_update"]["wrapper_ms"] = device_ms(
            torch, lambda: ops.sumtree_update(spec, upd_tree, upd_idx, upd_val))
        # every leaf of the storage in one gather launch, and its plain version
        out["gather"]["items"] = {
            "leaves": len(storage), "ms": device_ms(torch, lambda: ops.gather_items(storage, idx)),
            "plain_ms": device_ms(torch, lambda: [b[idx.clamp(0, capacity - 1)]
                                                  for b in storage.values()]),
            "call_ms": call_ms(torch, lambda: ops.gather_items(storage, idx))}
        torch.cuda.synchronize()
        return out

    # the floor under every launch: an empty kernel queued back to back
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"[launch floor] torch.cuda._sleep(0): device {floor_ms * 1e3:.2f} us | {card}",
          flush=True)
    main_t = measure(50_000, 64)
    big_t = measure(1_000_000, 512)
    tok_t = measure(8192, 8, token=True)
    chains = {
        "main path 50,000/B=64, CartPole's 5 leaves": sampling_chain(torch, dev, gen, 50_000, 64),
        "token replay 8,192/B=8, 4 (256,) leaves": sampling_chain(torch, dev, gen, 8192, 8,
                                                                  token=True)}
    for c in chains.values():
        print(f"[sampling chain] {c['capacity']:,}/K={c['K']}/B={c['B']}, {c['leaves']} leaves: "
              + "; ".join(f"{name} device {a['device_ms'] * 1e3:.2f} us, call "
                          f"{a['call_ms'] * 1e3:.1f} us" for name, a in c["arms"].items())
              + f" | {card}", flush=True)

    info = {
        "sumtree_sample": ("src/repro/kernels/sumtree_sample.py:111", "main",
                           "redesigned: one round trip a level (descend.cuh)"),
        "gather": ("src/repro/kernels/gather.py:60", "main",
                   "redesigned: every storage leaf in one launch, PDL"),
        "sample_gather": ("src/repro/kernels/sample_gather.py:119", "fused",
                          "redesigned: descend.cuh, then every leaf's row in flight at once"),
        "sumtree_update": ("src/repro/kernels/sumtree_update.py:110", "eager",
                           "redesigned: in-CTA last-writer dedup, segmented sums, no atomics"),
    }
    kernels = []
    for name, (replaces, path, status) in info.items():
        counts = main_counts if path == "main" else arms[path]
        iters = main_iters if path == "main" else arm_iters
        m, b = main_t[name], big_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu", "status": status,
            "replaces": replaces, "launches": counts.get(name, 0),
            "path": path, "launches_per_iteration": counts.get(name, 0) / iters,
            "max_abs_err": err[name], **m,
            "shape": "capacity 50000, K=128, B=64",
            "at_1M_B512": b, "at_token_replay_8192_B8": tok_t[name],
        })
        if name == "sumtree_sample":
            kernels[-1]["fp_ties"] = ties
            kernels[-1]["launch_floor_ms"] = floor_ms
        if name == "gather":
            kernels[-1]["sampling_chain"] = chains
        t = tok_t[name]
        check(all(math.isfinite(x) for x in (m["ms"], m["plain_ms"], b["ms"], b["plain_ms"],
                                             t["ms"], t["plain_ms"])),
              f"timing of {name} is not finite")
        def lib(x):
            return f", library {x['library_ms'] * 1e3:.2f} us" if x["library_ms"] else ""
        print(f"[times] {name}: device {m['ms'] * 1e3:.2f} us (plain {m['plain_ms'] * 1e3:.1f}"
              f" us{lib(m)}, bound {m['bound_ms'] * 1e3:.4f} us by {m['bound_by']}, call "
              f"{m['call_ms'] * 1e3:.1f} us); at 1M/B=512 device {b['ms'] * 1e3:.2f} us "
              f"(plain {b['plain_ms'] * 1e3:.1f} us{lib(b)}, bound {b['bound_ms'] * 1e3:.4f} us); "
              f"at the token replay 8192/B=8 device {t['ms'] * 1e3:.2f} us (plain "
              f"{t['plain_ms'] * 1e3:.1f} us{lib(t)}, bound {t['bound_ms'] * 1e3:.4f} us) | {card}",
              flush=True)
        if name == "sumtree_update":
            print("[times] sumtree_update through ops.sumtree_update (the replay's call): "
                  + "; ".join(f"{where} device {x['wrapper_ms'] * 1e3:.2f} us"
                              for where, x in (("50,000/B=64", m), ("1M/B=512", b),
                                               ("8192/B=8", t))) + f" | {card}", flush=True)
        if name == "gather":
            print("[times] gather_items, every leaf in one launch: " + "; ".join(
                f"{where} {x['items']['leaves']} leaves device {x['items']['ms'] * 1e3:.2f} us "
                f"(plain {x['items']['plain_ms'] * 1e3:.1f} us, call "
                f"{x['items']['call_ms'] * 1e3:.1f} us)"
                for where, x in (("50,000/B=64", m), ("1M/B=512", b), ("8192/B=8", t)))
                + f" | {card}", flush=True)
    print(f"[main path rate] {json.dumps(main_rate)}", flush=True)

    clock("7 (flash)")
    kernels += flash_phases(torch, dev, card)
    # Phases 17, 18, 19 and 26 run most of their work in processes of their
    # own that need nothing of this one but the card.  Those processes run
    # beside in-process phases that check results and time nothing on the
    # card, and are waited for before the next phase that times: 17's and
    # 18's ranks beside 11-13 (at most 7 at once, with this process 8, the
    # host's cores), 26(b)-(c)'s and 19's gangs beside 15-16, 22 and 19(c)
    # (26(b)'s two ranks take ~60 GB of the card at once, 13 as much: the two
    # never overlap)
    def c_after_17():
        ac_runs.result()
        return sharded_world4()

    with ThreadPoolExecutor(3) as pool:
        ac_runs = pool.submit(actor_critic_ranks, card)
        sharded_runs = pool.submit(sharded_ranks, pool.submit(c_after_17))
        clock("11 (flash backward), 17's and 18's ranks beside 11-13")
        bwd_entries, train_counts = train_phases(torch, dev, card, settle=sharded_runs.result)
    for entry in kernels:       # the replay kernels and the forward on the training path
        entry["train_launches"] = train_counts.get(entry["name"], 0)
    kernels += bwd_entries

    # 17. the actor-critics' checks, then the sampling chain (timed) here
    clock("17 (actor-critics)")
    actor_critic = actor_critic_phase(torch, dev, card, ac_runs.result())
    # 18. the sharded runtime, its ranks on this card; each rank's launches
    # counted from 0 over the SHARDED_ITERS iterations of 18(b)
    clock("18 (sharded)")
    sharded = sharded_phase(torch, dev, card, sharded_runs.result())
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[beside 15-22] this process holds {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB "
          f"of the card as 26(b)-(c)'s ranks start", flush=True)
    with ThreadPoolExecutor(2) as pool:
        shard_ranks = pool.submit(sharding_ranks, str(dev))
        gangs = pool.submit(service_gangs)
        # 15-16. the restart and the async loop; each path's launches counted
        # from 0
        clock("15-16 (restart, async), 26(b)-(c)'s ranks and 19's gangs beside 15-16, "
              "22 and 19(c)")
        restart = restart_phase(torch, dev, card)
        async_rate = async_phase(torch, dev, card)
        # 22. the ratio-scheduled token-DQN trainer, its launches counted from 0
        clock("22 (token-DQN trainer)")
        trainer = token_trainer_phase(torch, dev, card)
        # 19. the replay service: its roles as processes on this card, the
        # server's launches counted from its start; first in process
        clock("19 (service)")
        service = service_phase(torch, dev, card, gangs)
        t0 = time.perf_counter()
        shard_ranks.result()
        print(f"[beside 15-22] waited {time.perf_counter() - t0:.1f} s for 26(b)-(c)'s ranks",
              flush=True)
    # 20. the DSE and the wall-clock gang: the plan-built executor's launches
    # counted from 0; each gang rank's from its start
    clock("20 (dse)")
    dse_res = dse_phase(torch, dev, card)
    # 21. Qwen1.5-32B and Command-R-35B at full width, each alone on the card,
    # the forward's launches counted from 0 over each one's served requests
    # 27(c)'s dry run starts here, in a process of its own beside phases 21-27
    import tempfile
    dryrun_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dryrun = (*dryrun27_start(dryrun_dir), dryrun_dir)
    clock("21 (big dense serving)")
    big = big_dense_phase(torch, dev, card)
    # 23. Mixtral-8x7B and Llama-4 Maverick served at full width, Phi-3-vision
    # with its patch prefix; the forward's launches counted from 0 over each
    # one's served requests and over Phi-3-vision's prefill
    clock("23 (moe and vlm)")
    moe_vlm = moe_vlm_phase(torch, dev, card)
    # 24. Hymba-1.5B and xLSTM-125M at full width and depth, each alone on the
    # card: the forward's launches counted from 0 over Hymba's prefill, and
    # every kernel's over each training run
    clock("24 (hybrid and ssm)")
    recurrent = hybrid_ssm_phase(torch, dev, card)
    # 25. Whisper-medium at full width and depth: the forward's launches counted
    # from 0 over a prefill, and every kernel's over each train step
    clock("25 (audio)")
    audio = audio_phase(torch, dev, card)
    for entry in kernels:
        entry["restart_launches"] = restart["launches"].get(entry["name"], 0)
        entry["async_launches"] = async_rate["launches"].get(entry["name"], 0)
        entry["pendulum_launches"] = {name: r["launches"].get(entry["name"], 0)
                                      for name, r in actor_critic["agents"].items()}
        entry["sharded_launches_per_rank"] = [r["launches"].get(entry["name"], 0)
                                              for r in sharded["b"]]
        entry["service_launches"] = {"1-shard gang": service["a"]["launches"].get(entry["name"], 0),
                                     "2-shard fused gang": service["b"]["launches"].get(entry["name"], 0),
                                     "ServiceExecutor": service["c"]["launches"].get(entry["name"], 0)}
        if entry["name"] == "gather":
            entry["sampling_chain"]["Pendulum 50,000/B=64, 5 leaves"] = actor_critic["chain"]
        name = entry["name"]
        entry["dse_launches"] = dse_res["a"]["launches"].get(name, 0)
        entry["gang_launches"] = {
            "fused, 1 process": dse_res["b"]["launches"].get(name, 0),
            "bench, 2 ranks": [r.get(name, 0) for r in dse_res["c"]["plain"]["launches"]],
            "bench, 2 ranks, host publish 3": [
                r.get(name, 0) for r in dse_res["c"]["publish 3"]["launches"]]}
        if name in dse_res["e"]["flash_launches"][0]:
            entry["wallclock_train_launches"] = [f[name] for f in dse_res["e"]["flash_launches"]]
        if name in dse_res["e"]["times"]:
            entry["at_wallclock_train_shape"] = dse_res["e"]["times"][name]
        entry["big_dense_serve_launches"] = {r["model"]: r["serve"]["launches"].get(name, 0)
                                             for r in big.values()}
        if name == fa.SM90_NAME:
            entry["at_big_dense_prefill"] = {r["model"]: r["flash_times"] for r in big.values()}
        entry["token_dqn_trainer_launches"] = trainer["launches"].get(name, 0)
        entry["moe_vlm_launches"] = {
            **{r["model"]: r["serve"]["launches"].get(name, 0) for r in moe_vlm["moe"].values()},
            moe_vlm["vlm"]["model"] + ", one prefill": moe_vlm["vlm"]["launches"].get(name, 0)}
        if name == fa.SM90_NAME:
            entry["at_moe_vlm_shapes"] = moe_vlm["flash_times"]
        entry["hybrid_ssm_launches"] = {
            "Hymba-1.5B, one prefill": recurrent["hymba_serve"]["launches"].get(name, 0),
            "Hymba-1.5B, one train step": recurrent["hymba_train"]["launches"].get(name, 0),
            "xLSTM-125M, one train step": recurrent["xlstm_train"]["launches"].get(name, 0),
            "xLSTM-125M, one prefill": recurrent["xlstm_serve"]["launches"].get(name, 0)}
        if name == fa.SM90_NAME:
            entry["at_hybrid_shapes"] = recurrent["flash_times"]
        if name in recurrent["bwd_times"]:
            entry["at_hybrid_train_shape"] = recurrent["bwd_times"][name]
        entry["audio_launches"] = {
            "Whisper-medium, one prefill": audio["serve"]["launches"].get(name, 0),
            "Whisper-medium, each train step": [r["launches"].get(name, 0)
                                                for r in audio["train"]["steps"]]}
        if name == fa.SM90_NAME:
            entry["at_whisper_shapes"] = audio["flash_times"]
        if name in audio["bwd_times"]:
            entry["at_whisper_shapes"] = audio["bwd_times"][name]
    clock("26 (sharding)")
    shard_res = sharding_phase(torch, dev, card, ranks=shard_ranks)
    for entry in kernels:
        name = entry["name"]
        entry["sharding_launches"] = {
            "26(a) 1x1, the sharded step": shard_res["a"]["counts_sharded"].get(name, 0),
            "26(b) 1x2, each rank": [r["launches"].get(name, 0) for r in shard_res["b"]],
            "26(c) 2x1 SMOKE, each rank": [r["launches"].get(name, 0) for r in shard_res["c"]],
            "26(d) --mesh 16x16 run": shard_res["d"]["replay_launches"].get(name, 0)}
    clock("27 (sharded serving, dry run)")
    serve27 = sharded_serve_phase(torch, dev, card, dryrun, shard_res.get("serve27"))
    for entry in kernels:
        name = entry["name"]
        entry["sharded_serve_launches"] = {
            "27(a) unsharded server": serve27["a"]["unsharded"]["launches"].get(name, 0),
            "27(a) 1x1 server": serve27["a"]["sharded"]["launches"].get(name, 0),
            "27(b) 1x2, each rank": [r["launches"].get(name, 0) for r in serve27["b"]]}
    clock("28 (the port's lint)")
    lint = lint_phase(torch, dev, card)
    for entry in kernels:
        entry["lint_witness_launches"] = lint["b"]["launches"].get(entry["name"], 0)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
