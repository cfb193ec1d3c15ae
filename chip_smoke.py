#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero at the first
failure and prints no result):

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — every CUDA kernel from src/repro_torch/kernels/csrc, and the
                count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in
                the SASS (cuobjdump) of each of the three Hopper flash kernels
                (the forward, dQ and dK/dV), none of which may be 0;
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
                count equal to the tree op's calls; then the main path's
                profiler window over 20 more iterations of each arm;
  6. times    — the launch floor (torch.cuda._sleep(0)); each kernel, its
                plain version and the library call (searchsorted on the
                leaves' CDF for the descent, index_select for the gather):
                device time, the median of 60 calls queued back to back
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
                buckets 128/256/512, max_len 544), 16 requests of 1-512
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
                and dK/dV kernels for bf16 at hd 64/96/128, the f32-FMA pair
                for f32 and hd 16) against the plain backward (in f32 on the
                same q, k, v, dO and the forward kernel's O and LSE), on all
                of phase 7's cases (the serve and train shapes, (32, 4096,
                128), hd 96 at S = 1000, sliding and chunked at hd 128) under
                parity.flash_bwd_check, one launch of each kernel of the pair
                and none of the other, and a second call bit for bit the same;
                and the FlashAttention Function's gradients against autograd
                through the plain forward, three masks at (3, 200, 64) f32;
 12. grad gate — InternLM2-1.8B at its published width and depth in bf16,
                one TD loss and its gradients on each of four seeded (8, 256)
                batches with flash and with naive attention, against the same
                weights in f32 (naive, TF32 off): flash's gradients, per-position
                Q(s, a) and TD no farther from the f32 model than 1.1x naive's
                (the loss and the per-sequence |TD| reported beside them);
 13. train    — `python -m repro_torch.launch.train`'s main at InternLM2-1.8B's
                full width and depth, flash, --seq 256 --batch 8 --n-envs 16
                --steps 3 --ckpt-every 2: 48 Hopper forward, 24 Hopper dQ and
                24 Hopper dK/dV launches per train step (none of the f32
                forward and backward kernels) and the sample and gather
                kernels on every step,
                finite losses, moved parameters, the tree's root changed at the
                flush after update_priorities, the step-4 checkpoint restored
                into a fresh state bit for bit, the sample and gather kernels
                against their plain versions on the run's own tree and token
                rows, a profiled train step, and a second call with --steps 4
                that resumes from step 3;
 14. bwd times — the Hopper dQ and dK/dV kernels and the f32-FMA pair at
                (128, 256, 128) and (32, 4096, 128) bf16 causal beside their
                bounds, their plain versions and one SDPA backward call that
                computes all three gradients, with the TFLOP/s reached on the
                work the bounds count (3 and 4 products a pair) and on the
                products the kernels do (the hi/lo splits: 4 and 7);
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
                4 for 700 iterations at the main path's settings: return
                above 30, one descent and one gather launch per learner
                call, no host sync in a step, a profiler window;
 17. actor-critic — DDPG, TD3 and SAC on Pendulum x 8 at the settings of
                benchmarks/fig10_scalability.py (hidden (256, 256), capacity
                50,000 K=128, batch 64, warmup 64, epsilon 0.1), 300
                iterations each: finite losses and priorities, actions in
                [-2, 2], one descent and one gather launch per learner call,
                no host sync in a step; then the descent, the gathers and
                the fused kernel against their plain versions on the run's
                own tree and 12/4/4/12/4-byte rows; one learn step on the
                card against the same step on the CPU from the same state,
                batch and noise (rtol 1e-4, atol 1e-5 on the loss, |TD| and
                every parameter and target tensor); the mean return and
                iterations per second (not gated) and a profiler window;
                then the sampling chain on Pendulum's five leaves.

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
                capacity 10,000 and batch 32 a shard, K=128), 700 iterations:
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
                exiting at 300 learn steps and a fresh one resuming from its
                checkpoint to 600: two #3 launches a sample and no #1 or #2,
                RESUMED_FROM 300, the band; (c) in process: ServiceExecutor (1
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
                20,000 x K=128, batch 64, warmup 64) and run 200 iterations:
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
                launched as the code predicts on each worker, none of the
                Hopper ones; then those three kernels' times at the trainer's
                shape (32, 128, 16) f32 causal beside their plain versions,
                SDPA and their bounds.

Between phases 4 and 5 a torch.profiler window of 20 main-path
iterations gives the device-busy share and the ops per iteration; phase
5 takes the same window on each arm.
Granite-8B's weights and its f32 copy are freed before phase 11; phase 12
runs before the training state and the 34.3 GB token-MDP table exist, and
each training run's state is freed before the next.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  The line before that one is
the ``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import contextlib
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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
SEED = 0
N_TIMED = 60
GATE_BATCHES = 4
# (n, s, hd, attention, window, causal, is_global, dtype) of the flash
# kernels' parity phases (7 and 11): the five mask cases of
# tests/test_flash_attention.py, hd 16/96/128, a ragged S = 200, bf16
FLASH_CASES = [
    (4, 256, 64, "full", 0, True, True, "float32"), (4, 256, 64, "full", 0, False, True, "float32"),
    (4, 256, 64, "sliding", 64, True, False, "float32"),
    (4, 256, 64, "sliding", 64, True, True, "float32"),
    (4, 256, 64, "chunked", 64, True, False, "float32"), (8, 128, 16, "full", 0, True, True, "float32"),
    (3, 200, 128, "full", 0, True, True, "float32"), (3, 200, 96, "sliding", 50, True, False, "float32"),
    (2, 200, 64, "chunked", 48, False, False, "float32"),
    (4, 200, 64, "sliding", 64, True, False, "bfloat16"),
    (32, 128, 128, "full", 0, True, True, "bfloat16"),
    (32, 512, 128, "full", 0, True, True, "bfloat16")]
# phase 7's further bf16 cases, of the Hopper forward: the serve and train
# shapes at full size, hd 96 at a ragged S, sliding and chunked at hd 128
FLASH_SM90_CASES = [
    (32, 4096, 128, "full", 0, True, True, "bfloat16"),
    (128, 256, 128, "full", 0, True, True, "bfloat16"),
    (3, 1000, 96, "full", 0, True, True, "bfloat16"),
    (4, 512, 128, "sliding", 128, True, False, "bfloat16"),
    (4, 512, 128, "chunked", 128, True, False, "bfloat16")]


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
    from repro_torch.kernels import ops, parity
    from repro_torch.models import backbone
    from repro_torch.serve import ActorServeConfig, ActorServer, BucketSpec

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def qkv(n, s, hd, dtype):
        return [(torch.randn((n, s, hd), generator=gen, device=dev) * 0.3).to(dtype)
                for _ in range(3)]

    # 7. the forward kernels against their plain version, run in f32 on the
    # same inputs; each case goes to the kernel _fwd_kernel_for picks
    cases = FLASH_CASES + FLASH_SM90_CASES
    err = {name: {"max_abs_err": 0.0, "bf16_max_ulps_beyond_atol": 0.0, "lse_max_rel": 0.0,
                  "cases": 0} for name in (fa.NAME, fa.SM90_NAME)}
    for n, s, hd, attn, win, causal, glob, dt in cases:
        dt = getattr(torch, dt)
        q, k, v = qkv(n, s, hd, dt)
        name = fa._fwd_kernel_for(dt, hd)
        before = ops.launch_counts[name]
        o, lse = fa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
        o_ref, lse_ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), attn, win,
                                                  causal, glob)
        torch.cuda.synchronize()
        rep = parity.flash_check(o, lse, o_ref, lse_ref)
        check(o.dtype == dt and rep.ok and ops.launch_counts[name] == before + 1,
              f"{name} at ({n}, {s}, {hd}) {attn} window {win} causal={causal} "
              f"global={glob} {dt}: {rep}")
        e = err[name]
        e["max_abs_err"] = max(e["max_abs_err"], rep.max_abs_err)
        e["bf16_max_ulps_beyond_atol"] = max(e["bf16_max_ulps_beyond_atol"], rep.max_ulps)
        e["lse_max_rel"] = max(e["lse_max_rel"], rep.lse_max_rel)
        e["cases"] += 1
        del q, k, v, o, lse, o_ref, lse_ref
    f32e, sm90e = err[fa.NAME], err[fa.SM90_NAME]
    print(f"[flash parity] {len(cases)} cases agree with the plain version: {fa.NAME} "
          f"{f32e['cases']} cases (f32 max |err| {f32e['max_abs_err']:.3g}, atol 2e-6 + rtol "
          f"1e-4); {fa.SM90_NAME} {sm90e['cases']} cases (bf16 max |err| "
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
    lens = rng.randint(1, 513, size=16)
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
    check(generated == 16 * 32 == st["admissions"] + st["decoded_tokens"]
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

    rate = {"model": cfg.name, "params": n_params, "init_s": init_s, "requests": 16,
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
          f"16 requests x 32 tokens on 8 slots, {int(lens.sum())} prompt tokens; flash: "
          f"{f['first_tokens_per_s']:.2f} first-tokens/s, {f['decode_tokens_per_s']:.1f} decode "
          f"tokens/s, p50 {f['latency_p50_ms']:.0f} ms, p99 {f['latency_p99_ms']:.0f} ms; naive: "
          f"{nf['first_tokens_per_s']:.2f} first-tokens/s, {nf['decode_tokens_per_s']:.1f} decode "
          f"tokens/s; peak memory {peak / 2**30:.2f} GiB; flash launches {flash_launches} = "
          f"{per_prefill} x {st['admissions']} prefills x 1 pass; prefill logits flash vs "
          f"naive rel l2 {fn_rel:.4g} (each from the f32 model: flash {rel['fx']:.4g}, naive "
          f"{rel['nx']:.4g}); first tokens agree {first_agree}/16, all tokens "
          f"{token_agree}/{16 * 32} | {card}", flush=True)
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
    f32t = fwd_times(4, 256, 64, torch.float32, F32_OPS_PER_S, fa.flash_attention_cuda)
    print(f"[times] {fa.NAME} (4, 256, 64) f32 causal: device {f32t['ms'] * 1e3:.1f} us (plain "
          f"{f32t['plain_ms'] * 1e3:.1f} us, SDPA {f32t['library_ms'] * 1e3:.1f} us, bound "
          f"{f32t['bound_ms'] * 1e3:.2f} us by {f32t['bound_by']}, call "
          f"{f32t['call_ms'] * 1e3:.1f} us) | {card}", flush=True)
    torch.cuda.empty_cache()
    e32 = {k: v for k, v in err[fa.NAME].items() if k != "bf16_max_ulps_beyond_atol"}
    return [{"name": fa.SM90_NAME, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{fa.SM90_NAME}.cu",
             "replaces": "src/repro/kernels/flash_attention.py:123", "launches": flash_launches,
             "path": "serve", "launches_per_prefill": per_prefill, **err[fa.SM90_NAME],
             **times[(32, 512)], "shape": "(32, 512, 128) bf16 causal",
             "at_32x4096": times[(32, 4096)], "at_128x256": times[(128, 256)]},
            {"name": fa.NAME, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{fa.NAME}.cu",
             "replaces": "src/repro/kernels/flash_attention.py:123",
             "launches": counts.get(fa.NAME, 0), "path": "none (f32 and hd 16 only)", **e32,
             **f32t, "shape": "(4, 256, 64) f32 causal"}]


# -- phases 11-14: the flash backward and the token-DQN training path ----------


def sdpa_backward(torch, q4, k4, v4, do4):
    """One PyTorch call that computes dQ, dK and dV of causal attention (the
    library yardstick of the dQ + dK/dV pair, never called by the port):
    the flash backend's backward, or the efficient one if flash refuses."""
    aten = torch.ops.aten
    try:
        out = aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)
        o, lse, cq, ck, mq, mk, seed, offset = out[:8]
        call = lambda: aten._scaled_dot_product_flash_attention_backward(  # noqa: E731
            do4, q4, k4, v4, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset)
        call()
        return "flash", call
    except RuntimeError:
        o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, None, True, 0.0, True)
        return "efficient", lambda: aten._scaled_dot_product_efficient_attention_backward(
            do4, q4, k4, v4, None, o, lse, seed, offset, 0.0, [True, True, True, False], True)


def train_phases(torch, dev, card: str) -> list:
    """Phases 11-14 → the dQ and dK/dV kernels' entries of the kernels line
    and the training path's launch counts."""
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
    from repro_torch.kernels import ops, parity
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
    bwd_cases = FLASH_CASES + FLASH_SM90_CASES
    bwd_names = (fa.DQ_SM90_NAME, fa.DKV_SM90_NAME, fa.DQ_NAME, fa.DKV_NAME)
    # each kernel's worst case: dQ's own, dK/dV's over dK and dV
    per_kernel = {name: {"max_abs_err": 0.0, "bf16_max_ulps_beyond_atol": 0.0, "cases": 0}
                  for name in bwd_names}
    for n, s, hd, attn, win, causal, glob, dt in bwd_cases:
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
        case = (f"({n}, {s}, {hd}) {attn} window {win} causal={causal} global={glob} {dt}")
        check(all(t.dtype == dt for t in got) and rep.ok,
              f"flash backward {chosen} at {case}: {rep}")
        check(launched == {name: int(name in chosen) for name in bwd_names},
              f"flash backward at {case} launched {launched}, expected one each of {chosen}")
        check(same, f"flash backward {chosen} at {case}: a second call gave other gradients")
        for kern, grads in ((chosen[0], ("dq",)), (chosen[1], ("dk", "dv"))):
            e = per_kernel[kern]
            for g in grads:
                worst, ulps = rep.per[g]
                e["max_abs_err"] = max(e["max_abs_err"], worst)
                e["bf16_max_ulps_beyond_atol"] = max(e["bf16_max_ulps_beyond_atol"], ulps)
            e["cases"] += 1
        del q, k, v, do, o, lse, got, again, ref
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
    print(f"[flash bwd parity] {len(bwd_cases)} cases: dQ, dK, dV agree with the plain backward, "
          f"a second call bit for bit: the Hopper pair {sm90e['cases']} cases (bf16 max |err| dQ "
          f"{per_kernel[fa.DQ_SM90_NAME]['max_abs_err']:.3g}, dK/dV {sm90e['max_abs_err']:.3g}, "
          f"at most {max(sm90e['bf16_max_ulps_beyond_atol'], per_kernel[fa.DQ_SM90_NAME]['bf16_max_ulps_beyond_atol']):.3f} "
          f"bf16 ulp beyond atol 2e-5; 1 allowed); the f32 pair {f32e['cases']} cases (f32 max "
          f"|err| dQ {per_kernel[fa.DQ_NAME]['max_abs_err']:.3g}, dK/dV {f32e['max_abs_err']:.3g}, "
          f"atol 2e-5 + rtol 1e-3); FlashAttention's gradients vs autograd through the plain "
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
           cfg.vocab_size, cfg.rope_theta, cfg.dtype)
          == (24, 2048, 16, 8, 128, 8192, 92544, 1e6, "bfloat16"),
          f"not InternLM2-1.8B's published shape: {cfg}")
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
        check(gate_counts.get(fa.SM90_NAME) == 2 * layers and not gate_counts.get(fa.NAME)
              and gate_counts.get(fa.DQ_SM90_NAME) == layers
              and gate_counts.get(fa.DKV_SM90_NAME) == layers
              and not gate_counts.get(fa.DQ_NAME) and not gate_counts.get(fa.DKV_NAME),
              f"one TD loss and its gradients launched {gate_counts}, expected {2 * layers} "
              f"Hopper forward and {layers} Hopper dQ and dK/dV")
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
        del arms, x
        for key in held:
            check(row["flash"][key] <= 1.1 * row["naive"][key],
                  f"batch {bi}: flash bf16 {key} are {row['flash'][key]:.4g} relative l2 from "
                  f"the f32 model, naive's {row['naive'][key]:.4g}: flash adds error")
        print(f"[grad gate] batch {bi}: relative l2 from the same weights in f32, flash vs "
              + ", ".join(f"{k} {row['flash'][k]:.4g} vs {row['naive'][k]:.4g} "
                          f"({row['flash'][k] / row['naive'][k]:.3f}x)" for k in held + shown)
              + f"; worst tensor flash {row['flash']['worst_tensor'][1]} "
              f"{row['flash']['worst_tensor'][0]:.4g}, naive {row['naive']['worst_tensor'][1]} "
              f"{row['naive']['worst_tensor'][0]:.4g}", flush=True)
    print(f"[grad gate] {cfg.name} bf16, (8, 256) batches, {GATE_BATCHES} batches: flash no "
          f"farther than 1.1x naive from the f32 model in {', '.join(held)} on every batch; "
          f"launches per TD loss + gradients {gate_counts} | {card}", flush=True)
    del params, exact
    gc.collect()
    torch.cuda.empty_cache()

    clock("13 (train)")
    # 13. the training path through its entry point, at full width and depth
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = ["--arch", "internlm2_1_8b", "--attn-impl", "flash", "--seq", "256", "--batch", "8",
            "--n-envs", "16", "--ckpt-every", "2", "--ckpt-dir", ckpt, "--seed", str(SEED)]
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = train.main(argv + ["--steps", "3"])
        train_counts = dict(ops.launch_counts)
        hist, state = res["history"], res["state"]
        steps = len(hist)
        check(steps == 3 and res["start"] is None, f"{steps} steps, start {res['start']}")
        want = {fa.SM90_NAME: 2 * layers * steps, fa.NAME: None,
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
        moved = max(float((p.detach() - t).abs().max()) for p, t in
                    zip(state.params.parameters(), state.target.parameters()))
        check(moved > 0, "the online network never moved from its target copy")
        check(res["root_after_flush"] != res["root_before_flush"],
              f"the tree's root total did not change at the flush after update_priorities "
              f"({res['root_before_flush']})")
        # the checkpoint of the last step restores into a fresh state bit for bit
        mgr = CheckpointManager(ckpt, keep=2)
        check(mgr.all_steps() == [2, 3], f"checkpoints {mgr.all_steps()}, expected [2, 3]")
        t0 = time.perf_counter()
        fresh = token_dqn.init_train_state(res["cfg"], res["tcfg"],
                                           torch.Generator(device=dev).manual_seed(SEED + 99))
        got = mgr.restore(3, state_tensors(fresh))
        restore_s = time.perf_counter() - t0
        saved = state_tensors(state)
        same = sum(bool(torch.equal(t, saved[k])) for k, t in got.items())
        check(same == len(saved) == len(got), f"{len(got) - same} of {len(got)} tensors did not "
              f"restore bit for bit")
        del fresh, got, saved
        gc.collect()
        torch.cuda.empty_cache()
        # the replay kernels against their plain versions on the run's own
        # tree and token rows, at the path's B = 8 and at 65,536 draws: the
        # indices under the fp-tie rule, the rows bit for bit
        replay, rst = res["replay"], res["replay_state"]
        for draws in (8, 65_536):
            u = torch.rand((draws,), generator=gen, device=dev)
            ki, kp = ops.sumtree_sample(replay.spec, rst.tree, u)
            pi, pp = sumtree.sample(replay.spec, rst.tree, u)
            torch.cuda.synchronize()
            rep = parity.sample_ties(replay.spec, rst.tree, u, ki, pi)
            check(rep.ok, f"sumtree_sample on the training run's tree, {draws} draws: {rep}")
            agree = ki == pi
            torch.testing.assert_close(kp[agree], pp[agree], rtol=1e-5, atol=0)
            items = ops.gather_items(rst.storage, ki)
            for key, buf in rst.storage.items():
                check(torch.equal(ops.prioritized_gather(buf, ki), buf[ki])
                      and torch.equal(items[key], buf[ki]),
                      f"gather of the training run's {key} rows {tuple(buf.shape)} {buf.dtype}")
        print(f"[train replay parity] capacity {replay.spec.capacity}, K={replay.spec.fanout}, "
              f"{rst.count} rows filled: sample indices agree with the plain descent under the "
              f"fp-tie rule at 8 and 65,536 draws ({rep.flips} flipped at 65,536, at most "
              f"{rep.allowed}), gathered rows bit for bit", flush=True)
        # where one train step's time goes
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            idx, items, w = replay.sample(rst, gen, 8)
            state, _, _ = token_dqn.train_step(res["cfg"], res["tcfg"], state,
                                               dict(items, is_weights=w))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        step_prof = profile_summary(torch, prof, wall, 1)
        optimal = res["optimal_reward"]
        del res, state, replay, rst, items, w, idx, prof
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(ckpt, "step_2"))   # the card's machine has ~75 GB of disk
        # a second call resumes from step 3
        printed = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            res2 = train.main(argv + ["--steps", "4"])
        resume_counts = dict(ops.launch_counts)
        print(printed.getvalue(), end="", flush=True)
        check("resumed from step 3" in printed.getvalue() and res2["start"] == 3
              and len(res2["history"]) == 1, f"the second call did not resume from step 3: "
              f"start {res2['start']}, {len(res2['history'])} steps")
        check(resume_counts.get(fa.DQ_SM90_NAME) == layers,
              f"resumed run launches {resume_counts}")
        peak = res2["peak_memory_bytes"] or 0
        hist2 = res2["history"]
        del res2
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    rate = {"model": cfg.name, "params": n_params, "steps": steps, "seq": 256, "batch": 8, "n_envs": 16,
            "collect_s": [h["collect_s"] for h in hist], "train_s": [h["train_s"] for h in hist],
            "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
            "reward": [h["reward"] for h in hist], "optimal_reward": optimal,
            "train_steps_per_s": steps / sum(h["train_s"] for h in hist),
            "restore_s": restore_s, "resumed_steps": [h["step"] for h in hist2],
            "peak_memory_bytes": peak, "launches": train_counts, "profile": step_prof,
            "grad_gate": gate}
    print(f"[train] {cfg.name} ({n_params / 1e9:.3f} B params) bf16, flash, (8 x 256) batch, 16 "
          f"actors: {steps} steps, collect {statistics.median(rate['collect_s']):.2f} s and train "
          f"step {statistics.median(rate['train_s']) * 1e3:.1f} ms (medians), "
          f"{rate['train_steps_per_s']:.3f} train steps/s of train-step time; launches "
          f"{train_counts}; restore {restore_s:.1f} s; resumed steps {rate['resumed_steps']}; "
          f"peak memory {peak / 2**30:.2f} GiB | {card}", flush=True)
    print(f"[train profile] one train step: {step_prof['wall_us']:,.0f} us wall, "
          f"{step_prof['device_busy_us']:,.0f} us device-busy ({step_prof['device_busy_share']} "
          f"busy share), {step_prof['device_ops_per_step']:,.0f} device ops | {card}", flush=True)
    print(f"[train rate] {json.dumps(rate)}", flush=True)

    clock("14 (backward times)")
    # 14. the backward kernels' times beside their bounds, their plain
    # versions and one SDPA backward call; the f32-FMA pair is the Hopper
    # pair's earlier version, timed on the same bf16 inputs
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
            fa.DQ_NAME: (lambda: fa.flash_attention_dq_cuda(*args), dq_plain, dq_bound, 3, 3),
            fa.DKV_NAME: (lambda: fa.flash_attention_dkv_cuda(*args), dkv_plain, dkv_bound, 4, 4),
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
        old = times[fa.DQ_NAME][s]["ms"] + times[fa.DKV_NAME][s]["ms"]
        print(f"[times] backward pair ({n}, {s}, 128) bf16 causal: Hopper {new * 1e3:.1f} us, f32 "
              f"pair {old * 1e3:.1f} us ({old / new:.2f}x), one SDPA backward "
              f"{lib_ms * 1e3:.1f} us ({new / lib_ms:.2f}x of it) | {card}", flush=True)
        del q, k, v, do, o, lse, delta, lib, args
        torch.cuda.empty_cache()
    entries = []
    for name, line, path, earlier in (
            (fa.DQ_SM90_NAME, 237, "train", fa.DQ_NAME),
            (fa.DKV_SM90_NAME, 255, "train", fa.DKV_NAME),
            (fa.DQ_NAME, 237, "none (f32 and hd 16 only)", None),
            (fa.DKV_NAME, 255, "none (f32 and hd 16 only)", None)):
        e = per_kernel[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": train_counts.get(name, 0), "path": path,
            "launches_per_train_step": train_counts.get(name, 0) / steps,
            "max_abs_err": e["max_abs_err"], "parity_cases": e["cases"], **times[name][256],
            "shape": "(128, 256, 128) bf16 causal", "at_32x4096": times[name][4096]}
        if earlier is None:
            entry["max_abs_err_dtype"] = "f32"
        else:
            entry["bf16_max_ulps_beyond_atol"] = e["bf16_max_ulps_beyond_atol"]
            entry["earlier"] = {"name": earlier, "ms": times[earlier][256]["ms"],
                                "at_32x4096_ms": times[earlier][4096]["ms"]}
        entries.append(entry)
    return entries, train_counts


# -- phases 15-17: the restart, the async loop and the actor-critics ---------

# one actor-critic learn step on the card against the same step on the CPU
LEARN_RTOL, LEARN_ATOL = 1e-4, 1e-5
# short enough for the script to stay well inside its time limit (the
# Pendulum returns are reported, not gated)
PENDULUM_ITERS = 300
# 16(c) and 18(b): the return passes 30 by iteration 256 on both paths and
# stays above 110 from iteration 448 on (their returns a chunk, recorded in
# the rate lines)
ASYNC_ITERS = 700


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
    _, rate["profile"] = profile_loop(torch, ex, st)
    print(profile_line("async arm", rate["profile"]), flush=True)
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


def actor_critic_phase(torch, dev, card: str, iterations: int = PENDULUM_ITERS) -> dict:
    """Phase 17: DDPG, TD3 and SAC on Pendulum at the settings of
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

    makers = {"ddpg": lambda s: ddpg.make_ddpg(s, ddpg.DDPGConfig()),
              "td3": lambda s: td3.make_td3(s, td3.TD3Config()),
              "sac": lambda s: sac.make_sac(s, sac.SACConfig())}
    env_fn = lambda n: make_vec("pendulum", n)  # noqa: E731
    spec, _, _ = env_fn(1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    out = {}
    for name, make in makers.items():
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
        _, res["profile"] = profile_loop(torch, ex, st)
        print(profile_line(f"{name} on Pendulum", res["profile"]), flush=True)
        out[name] = res
        del ex, st, hist, rst, replay, results
    chain = sampling_chain(torch, dev, gen, 50_000, 64,
                           storage=pendulum_storage(torch, dev, gen, 50_000))
    print(f"[sampling chain] Pendulum's 5 leaves (12/4/4/12/4 bytes), 50,000/K=128/B=64: "
          + "; ".join(f"{n} device {a['device_ms'] * 1e3:.2f} us, call {a['call_ms'] * 1e3:.1f} us"
                      for n, a in chain["arms"].items()) + f" | {card}", flush=True)
    print(f"[actor-critic rate] {json.dumps(out)}", flush=True)
    return {"agents": out, "chain": chain}


# -- phase 18: the sharded runtime, its shards as ranks on the one card -----------

SHARDED_ITERS = 700        # 18(b): see ASYNC_ITERS
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


def sharded_phase(torch, dev, card: str) -> dict:
    """Phase 18: the sharded runtime with its shards as ranks of
    torch.distributed on the one card (launch/mesh.py::spawn); every
    kernel is built before the first rank starts."""
    import shutil
    import tempfile

    from repro_torch.launch import mesh as meshlib

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    res = {}
    # (a) world 1 over NCCL
    a = meshlib.spawn(_sharded_world1, 1, backend="nccl", device="cuda:0", timeout_s=600)[0]
    for name in ("data_mesh(1)", "pod_data_mesh(1, 1)"):
        r = a[name]
        check(not r["metrics"] and not r["state"] and r["learn_steps"] > 0,
              f"18(a) ShardedExecutor({name}) is not FusedExecutor bit for bit: metrics "
              f"{r['metrics']}, state {r['state'][:4]}, learner calls {r['learn_steps']}")
    check(a["sync"] is None and a["learn_steps_after"] > a["pod_data_mesh(1, 1)"]["learn_steps"],
          f"18(a) a sharded step over NCCL synchronized with the host: {a['sync']}")
    print(f"[sharded a] world 1 over {a['backend']}: ShardedExecutor on data_mesh(1) and on "
          f"pod_data_mesh(1, 1) against FusedExecutor, 40 iterations from seed 7 (4 envs, "
          f"capacity 1,024 K=8, batch 32): {a['data_mesh(1)']['n_metrics']} metrics and "
          f"{a['data_mesh(1)']['n_state']} state tensors bit for bit; three more steps with "
          f"learning under set_sync_debug_mode('error'): no host sync | {card}", flush=True)
    res["a"] = a
    ckpt2 = tempfile.mkdtemp(prefix="chip_smoke_world2_")
    ckpt1 = tempfile.mkdtemp(prefix="chip_smoke_world1_")
    try:
        # (b) world 2 over gloo, both ranks on the one card
        b = meshlib.spawn(_sharded_world2, 2, ckpt2, backend="gloo", device="cuda:0",
                          timeout_s=900)
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
              f"({SHARDED_ITERS / secs:.2f} iterations/s, {secs / SHARDED_ITERS * 1e6:,.0f} us "
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
        c = meshlib.spawn(_sharded_world4, 4, backend="gloo", device="cuda:0", timeout_s=900)
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
                  f"pods, bf16 inside, {POD_ITERS} iterations in {rank0['seconds']:.2f} s; "
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
        # (d) elastic: world 2's learner state at world 1, world 1's at world 2
        d1 = meshlib.spawn(_elastic_world, 1, ckpt2, ckpt1, backend="nccl", device="cuda:0",
                           timeout_s=600)
        d2 = meshlib.spawn(_elastic_world, 2, ckpt1, None, backend="gloo", device="cuda:0",
                           timeout_s=600)
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
    finally:
        shutil.rmtree(ckpt2, ignore_errors=True)
        shutil.rmtree(ckpt1, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[sharded] phase 18 in {res['seconds']:.1f} s", flush=True)
    print(f"[sharded rate] {json.dumps({'iterations': SHARDED_ITERS, 'seconds': secs, 'iterations_per_s': SHARDED_ITERS / secs, 'wall_us_per_iteration': secs / SHARDED_ITERS * 1e6, 'return': ret, 'returns_by_chunk': b[0]['returns'], 'launches': [r['launches'] for r in b], 'profile': prof})}", flush=True)
    return res


# -- phase 19: the replay service, its roles as processes on the one card ------

SERVICE_LEARN_STEPS = 1400     # 19(a): the reference's run length, never shortened
SERVICE_RESTART_STEPS = 600    # 19(b): the 2-shard fused gang, restarted at 300
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


def service_phase(torch, dev, card: str) -> dict:
    """Phase 19: the replay service (src/repro_torch/service) through
    launch/multiprocess.py::launch_service, server, actors and learner
    each a process on this card and meeting over localhost TCP; then
    ServiceExecutor against FusedExecutor and an ActorServer fed by the
    service's params channel, in process."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.agents.base import state_tensors
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.configs import get_config
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.kernels import ops
    from repro_torch.launch import multiprocess as mp
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
    # (a) the 1-shard gang at the main path's width: #1 and #2 once a sample
    t0 = time.perf_counter()
    a = mp.launch_service(learn_steps=SERVICE_LEARN_STEPS, capacity_per_shard=20_000,
                          timeout_s=420.0, **SERVICE_GANG)
    secs = time.perf_counter() - t0
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
          f"{secs:.1f} s with its start); server launches {launches}; "
          f"{int(server['SAMPLE_HOST_COPIES']) / calls:.0f} device-to-host copies a sample (five "
          f"leaves and the weights) | {card}", flush=True)
    res["a"] = {"seconds": secs, "wall_ms_per_learn": wall_ms, "ms_per_learn": split, "learn_s":
                float(learner["LEARN_WALL_S"]), "return": ret, "launches": launches,
                "samples": calls, "realized_spi": float(server["REALIZED_SPI"]),
                "spi_tolerance": float(server["SPI_TOLERANCE"]),
                "inserts": int(server["INSERTS"]), "appends": int(server["APPENDS"]),
                "host_copies_per_sample": int(server["SAMPLE_HOST_COPIES"]) / calls}
    # (b) 2 shards, each sampled by #3, and the learner restart drill
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
          f"{secs_b:.1f} s | {card}", flush=True)
    res["b"] = {"seconds": secs_b, "launches": launches_b, "samples": calls,
                "wall_ms_per_learn": float(learner["WALL_PER_LEARN_MS"]),
                "return": float(learner["EVAL_RETURN"]), "counts": counts}
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
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[service] phase 19 in {res['seconds']:.1f} s", flush=True)
    print(f"[service rate] {json.dumps({k: res[k] for k in ('a', 'b', 'c')})}", flush=True)
    return res


# -- phase 20: the DSE, the planner and the wall-clock gang on the one card ------

DSE_LANES = (1, 2, 4, 8)        # 20(a): the profiled lane counts (fig12_dse's)
DSE_ITERS = 200                 # 20(a): the plan-built executor's run
GANG_FUSED_ITERS = 30           # 20(b): tests/test_multiprocess.py's degenerate launch
GANG_BENCH = ["--mode", "bench", "--n-data", "2", "--n-envs", "8", "--iters", "24",
              "--repeats", "3", "--scan-chunk", "20"]      # 20(c)
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


def f32_flash_times(torch, dev, n: int, s: int, hd: int) -> dict:
    """#5b, #6b and #7b (the f32 kernels) at (n, s, hd) f32 causal, the
    wall-clock trainer's shape: device time, plain version, the library
    (SDPA forward; one SDPA backward for dQ, dK and dV together) and the
    bound, by kernel name."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    q, k, v, do = ((torch.randn((n, s, hd), generator=gen, device=dev) * 0.3)
                   for _ in range(4))
    o, lse = fa.flash_attention_cuda(q, k, v)
    delta = fa.flash_delta(o, do)
    pairs = n * s * (s + 1) / 2                  # causal (query, key) pairs
    reads = 4 * n * s * hd * 4 + 2 * n * s * 4   # q, k, v, dO; lse, delta
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend, lib_bwd = sdpa_backward(torch, q[None], k[None], v[None], do[None])
    lib_bwd_ms = device_ms(torch, lib_bwd)
    args = (q, k, v, do, lse, delta)
    calls = {
        fa.NAME: (lambda: fa.flash_attention_cuda(q, k, v),
                  lambda: fa.flash_attention_plain(q, k, v),
                  device_ms(torch, lambda: sdpa(q[None], k[None], v[None], is_causal=True)),
                  bound(3 * n * s * hd * 4 + n * s * hd * 4 + n * s * 4, 4 * hd * pairs)),
        fa.DQ_NAME: (lambda: fa.flash_attention_dq_cuda(*args),
                     lambda: fa.flash_attention_dq_plain(*args), lib_bwd_ms,
                     bound(reads + n * s * hd * 4, 3 * 2 * hd * pairs)),
        fa.DKV_NAME: (lambda: fa.flash_attention_dkv_cuda(*args),
                      lambda: fa.flash_attention_dkv_plain(*args), lib_bwd_ms,
                      bound(reads + 2 * n * s * hd * 4, 4 * 2 * hd * pairs)),
    }
    out = {}
    for name, (kern, plain, lib_ms, (b_ms, b_by)) in calls.items():
        out[name] = {"ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": f"({n}, {s}, {hd}) f32 causal",
                     "library": "SDPA" if name == fa.NAME else
                     f"one SDPA {backend} backward call (dQ, dK and dV together)"}
        check(all(math.isfinite(out[name][x]) for x in ("ms", "plain_ms", "library_ms")),
              f"timing of {name} at ({n}, {s}, {hd}) is not finite")
    return out


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
    layers = 2      # granite_8b SMOKE
    want_flash = {fa.NAME: 2 * layers * WALLCLOCK_STEPS, fa.DQ_NAME: layers * WALLCLOCK_STEPS,
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
        print(f"[dse e] {name} at {t['shape']}, the wall-clock trainer's shape: device "
              f"{t['ms'] * 1e3:.2f} us (plain {t['plain_ms'] * 1e3:.1f} us, {t['library']} "
              f"{t['library_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.4f} us by "
              f"{t['bound_by']}) | {card}", flush=True)
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


# -- the phases ----------------------------------------------------------------


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE / "src"))

    from repro_torch.core import sumtree
    from repro_torch.kernels import _build, ops, parity
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
    main_iters = 1400
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

    # 5. the other two arms, each with the same profiler window; the launches
    # the code predicts: one fused launch a learner call; one update launch a
    # learner call and two an iteration (the insert's zeroing and its commit)
    arms, arm_profiles = {}, {}
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
        _, arm_profiles[arm] = profile_loop(torch, ex_a, st)
        print(profile_line(f"{arm} arm", arm_profiles[arm]), flush=True)
        del ex_a, st
    main_rate["arm_profiles"] = arm_profiles

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
    clock("11 (flash backward)")
    bwd_entries, train_counts = train_phases(torch, dev, card)
    for entry in kernels:       # the replay kernels and the forward on the training path
        entry["train_launches"] = train_counts.get(entry["name"], 0)
    kernels += bwd_entries

    # 15-17. the restart, the async loop and the actor-critics; each path's
    # launches counted from 0
    clock("15-16 (restart, async)")
    restart = restart_phase(torch, dev, card)
    async_rate = async_phase(torch, dev, card)
    clock("17 (actor-critics)")
    actor_critic = actor_critic_phase(torch, dev, card)
    # 18. the sharded runtime, its ranks on this card; each rank's launches
    # counted from 0 over the SHARDED_ITERS iterations of 18(b)
    clock("18 (sharded)")
    sharded = sharded_phase(torch, dev, card)
    # 19. the replay service: its roles as processes on this card, the server's
    # launches counted from its start; then in process
    clock("19 (service)")
    service = service_phase(torch, dev, card)
    # 20. the DSE and the wall-clock gang: the plan-built executor's launches
    # counted from 0; each gang rank's from its start
    clock("20 (dse)")
    dse_res = dse_phase(torch, dev, card)
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
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
