#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero at the first
failure and prints no result):

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — every CUDA kernel from src/repro_torch/kernels/csrc;
  3. parity   — each kernel against its plain PyTorch version on the card,
                at the main path's shapes (capacity 50,000, K=128, B=64),
                at the Nature-DQN replay size (1,000,000, K=128, B=512),
                at K=8 and K=256 (100,000) and on a tree whose root is
                bumped above its children (the padded-tail clamp), under
                the rules of src/repro_torch/kernels/parity.py: sampled
                indices under the fp-tie rule (at B and at 65,536 draws),
                rows bit-exact, the update's leaves bit for bit and each
                interior level at rtol 1e-5 plus 1e-6 of its magnitude;
  4. main path — FusedExecutor on CUDA with the settings of
                tests/test_system.py (CartPole × 8 envs, DQN (4, 256, 256, 2),
                capacity 20,000, K=128, batch 64, 1,400 iterations): the
                return must beat 30, the sample and gather kernels must
                have launched, and a step must not synchronize with the
                host (checked under torch.cuda.set_sync_debug_mode);
  5. arms     — 200 iterations each of the fused sample+gather arm and the
                eager-replay arm, which launch the other two kernels;
  6. times    — each kernel, its plain version and (for the gather) the
                library call: device time, the median of 60 calls queued
                back to back behind a GPU sleep, one CUDA-event pair each
                (the update kernel given its mask; the public wrapper, which
                computes the mask, is timed beside it); and the call latency
                from an idle card, Python wrapper included.

Between phases 4 and 5 a torch.profiler window of 20 main-path
iterations gives the device-busy share and the ops per iteration.

The line before the last is the card's name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  The line before that one is
the ``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
N_TIMED = 60


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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
    versions' many small launches fit in the launch queue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    while len(times) < N_TIMED:
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(per_round + 2)]
        evs[0].record()
        torch.cuda._sleep(int((4 * per_round * host_s + 0.005) * 2e9))  # ≥ that long below 2 GHz
        evs[1].record()
        t0 = time.perf_counter()
        for i in range(per_round):
            fn()
            evs[i + 2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if evs[0].elapsed_time(evs[1]) < enqueue_ms:
            fail("the GPU sleep ended before the timed calls were queued")
        times += [evs[i + 1].elapsed_time(evs[i + 2]) for i in range(per_round)]
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """Least time the card needs: bytes over memory rate or f32 operations
    over the f32 rate, whichever is larger → (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
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


# -- the phases ----------------------------------------------------------------


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE / "src"))

    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.core import sumtree
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.kernels import ops, parity
    from repro_torch.kernels import sumtree_update as kupdate
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

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
    print(f"[build] 4 kernels built in {secs:.1f} s (0 = already built)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"sumtree_sample": 0.0, "gather": 0.0, "sample_gather": 0.0,
           "sumtree_update": 0.0}

    def tree_for(capacity, fanout):
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

    def storage_for(capacity):
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

    # 3. parity: each kernel against its plain version on the card
    shapes = [("main path", 50_000, 128, 64), ("Nature DQN", 1_000_000, 128, 512),
              ("K=8", 100_000, 8, 512), ("K=256", 100_000, 256, 512),
              ("tiny tail", 10, 4, 64)]
    ties = {}
    for label, capacity, fanout, batch in shapes:
        spec, tree0 = tree_for(capacity, fanout)
        storage = storage_for(capacity)
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
            # 2: gather — bit-exact in every dtype, rank 1 to 3
            for name, buf in storage.items():
                got = ops.prioritized_gather(buf, ki)
                torch.testing.assert_close(got, buf[ki], rtol=0, atol=0)
            # 3: fused sample+gather ≡ split kernels
            fi, fp, items = ops.sumtree_sample_gather(spec, tree, u, storage)
            torch.testing.assert_close(fi, ki, rtol=0, atol=0)
            torch.testing.assert_close(fp, kp, rtol=0, atol=0)
            for name, buf in storage.items():
                torch.testing.assert_close(items[name], buf[ki], rtol=0, atol=0)
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
            want = sumtree.update(spec, tree0.clone(), idx, val, unique=unique)
            torch.cuda.synchronize()
            problems = parity.tree_mismatch(spec, got, want)
            check(not problems, f"sumtree_update at {label} (unique={unique}): {problems}")
            check(sumtree.check_invariant(spec, got), f"update broke the tree at {label}")
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
              "sample/gather/sample_gather/update agree; sample indices on the plain "
              f"tree + the bumped tree, {flips} (window "
              f"{reports[batch][0].window_ulp:g} ulp(total))", flush=True)

    # 4. main path: the paper's system through the user entry points
    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec_env, _, _ = env_fn(1)

    def run_arm(iterations, fused, lazy, capacity=20_000, warmup=400, seed=1):
        replay = PrioritizedReplay(
            ReplayConfig(capacity=capacity, fanout=128, fused_sample_gather=fused),
            transition_example(spec_env), device="cuda")
        check(replay.ops.name == "cuda", "the CUDA device did not default to the kernels")
        cfg = LoopConfig(batch_size=64, warmup=warmup, epsilon=0.2, lazy_replay=lazy)
        ex = FusedExecutor(make_dqn(spec_env, DQNConfig()), replay, env_fn, cfg,
                           n_envs=8)
        state = ex.init(seed)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = ex.run(state, iterations)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        # the step must never wait on the device: a few more steps with
        # every synchronizing CUDA call turned into an error
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                state, _ = ex.step(state)
        except RuntimeError as e:
            fail(f"a loop step (fused={fused}, lazy={lazy}) synchronized: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return ex, state, hist, secs, counts

    main_iters = 1400
    ex, state, hist, secs, main_counts = run_arm(main_iters, fused=False, lazy=True)
    replay = ex.replay
    final = float(hist["mean_episode_return"][-1])
    print(f"[main path] {main_iters} iterations in {secs:.2f} s: "
          f"{state.env_steps / secs:,.1f} env-steps/s, "
          f"{state.learn_steps / secs:,.1f} learner calls/s, final return {final:.1f}, "
          f"launches {main_counts}", flush=True)
    check(final > 30.0, f"main path return {final} does not beat 30")
    check(main_counts.get("sumtree_sample", 0) > 0 and main_counts.get("gather", 0) > 0,
          f"the main path did not launch the sample and gather kernels: {main_counts}")
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
                 "iterations": main_iters, "seconds": secs}

    # where the main path's time goes: a profiler window of steady iterations
    # (8 learner calls each), taken after the counted run
    prof_iters = 20
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = ex.run(state, prof_iters)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev_events)
    n_kernels = sum(e.count for e in dev_events)
    main_rate["profile"] = {
        "iterations": prof_iters, "wall_us_per_iteration": wall_us / prof_iters,
        "device_busy_us_per_iteration": busy_us / prof_iters,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "device_ops_per_iteration": n_kernels / prof_iters,
        "top": [[e.key[:70], e.count / prof_iters, e.self_device_time_total / prof_iters]
                for e in sorted(dev_events, key=lambda e: -e.self_device_time_total)[:12]],
    }
    if busy_us:
        print(f"[profile] {prof_iters} iterations under torch.profiler: "
              f"{wall_us / prof_iters:,.0f} us wall, {busy_us / prof_iters:,.1f} us "
              f"device-busy and {n_kernels / prof_iters:,.0f} device ops per iteration "
              f"(busy share {busy_us / wall_us:.4f})", flush=True)
    else:
        print("[profile] torch.profiler recorded no device time: busy share not "
              "measured", flush=True)

    # 5. the other two arms
    arms = {}
    for arm, fused, lazy, kernel in (("fused", True, True, "sample_gather"),
                                     ("eager", False, False, "sumtree_update")):
        _, st, h, s, counts = run_arm(200, fused=fused, lazy=lazy, warmup=400)
        check(counts.get(kernel, 0) > 0,
              f"the {arm} arm did not launch {kernel}: {counts}")
        check(bool(torch.isfinite(h["loss"]).all()), f"non-finite loss on the {arm} arm")
        arms[arm] = counts
        print(f"[{arm} arm] 200 iterations in {s:.2f} s: {st.env_steps / s:,.1f} "
              f"env-steps/s, {st.learn_steps / s:,.1f} learner calls/s, "
              f"launches {counts}", flush=True)

    # 6. times at the main path's shapes and at the Nature-DQN size
    def measure(capacity, batch):
        spec, tree = tree_for(capacity, 128)
        storage = {k: v for k, v in storage_for(capacity).items() if k != "frames"}
        u = torch.rand((batch,), generator=gen, device=dev)
        idx, _ = ops.sumtree_sample(spec, tree, u)
        obs = storage["obs"]
        upd_idx = torch.randint(0, capacity, (batch,), generator=gen, device=dev)
        upd_val = torch.rand((batch,), generator=gen, device=dev)
        upd_mask = sumtree.last_writer_mask(upd_idx, spec.num_leaves)
        upd_tree, plain_tree = tree.clone(), tree.clone()
        row_sum = sum(v[0].numel() * v.element_size() for v in storage.values())
        n_rows = int(torch.unique(idx).numel())
        sample_bytes = (4 + batch * 4 + rows_touched(torch, spec, idx) * spec.fanout * 4
                        + batch * 12)
        sample_ops = batch * spec.height * spec.fanout
        ob = obs[0].numel() * obs.element_size()
        calls = {
            "sumtree_sample": (lambda: ops.sumtree_sample(spec, tree, u),
                               lambda: sumtree.sample(spec, tree, u), None,
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
                lambda: kupdate.sumtree_update_cuda(spec, upd_tree, upd_idx, upd_val,
                                                    upd_mask),
                lambda: sumtree.update(spec, plain_tree, upd_idx, upd_val), None,
                bound(batch * 13 + nodes_touched(torch, spec, upd_idx) * 8,
                      batch * spec.height)),
        }
        out = {}
        for name, (kern, plain, lib, (bound_ms, bound_by)) in calls.items():
            out[name] = {"ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
                         "library_ms": device_ms(torch, lib) if lib else None,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "call_ms": call_ms(torch, kern)}
        # the public wrapper adds the last-writer mask (a sort) to the kernel
        out["sumtree_update"]["wrapper_ms"] = device_ms(
            torch, lambda: ops.sumtree_update(spec, upd_tree, upd_idx, upd_val))
        torch.cuda.synchronize()
        return out

    main_t = measure(50_000, 64)
    big_t = measure(1_000_000, 512)

    info = {
        "sumtree_sample": ("src/repro/kernels/sumtree_sample.py:111", "main"),
        "gather": ("src/repro/kernels/gather.py:60", "main"),
        "sample_gather": ("src/repro/kernels/sample_gather.py:119", "fused"),
        "sumtree_update": ("src/repro/kernels/sumtree_update.py:110", "eager"),
    }
    kernels = []
    for name, (replaces, path) in info.items():
        counts = main_counts if path == "main" else arms[path]
        iters = main_iters if path == "main" else 200
        m, b = main_t[name], big_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": counts.get(name, 0),
            "path": path, "launches_per_iteration": counts.get(name, 0) / iters,
            "max_abs_err": err[name], **m,
            "shape": "capacity 50000, K=128, B=64",
            "at_1M_B512": b,
        })
        if name == "sumtree_sample":
            kernels[-1]["fp_ties"] = ties
        check(all(math.isfinite(x) for x in (m["ms"], m["plain_ms"], b["ms"], b["plain_ms"])),
              f"timing of {name} is not finite")
        lib = f", library {m['library_ms'] * 1e3:.1f} us" if m["library_ms"] else ""
        print(f"[times] {name}: device {m['ms'] * 1e3:.2f} us (plain {m['plain_ms'] * 1e3:.1f}"
              f" us{lib}, bound {m['bound_ms'] * 1e3:.4f} us by {m['bound_by']}, call "
              f"{m['call_ms'] * 1e3:.1f} us); at 1M/B=512 device {b['ms'] * 1e3:.2f} us "
              f"(plain {b['plain_ms'] * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.4f} us)",
              flush=True)
    print(f"[main path rate] {json.dumps(main_rate)}", flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
