"""The port's replay service (repro_torch.service, DESIGN.md §11) against
the JAX package's (repro.service), on the CPU: rate-limiter flow
control, router addressing, the service core and its TCP wire path, the
params channel, and the in-process ServiceExecutor.

Held against the reference:
  * the copied ``RateLimiter`` and ``Router`` give the reference's
    decisions, exactly, on one seeded sequence of admissions and writer
    ids;
  * the stratified multi-shard sample, fed the uniforms that the
    reference's ``ReplayService._make_sample_fn`` draws, gives the same
    indices (a flip only at an fp CDF tie, the rule of
    tests/test_kernels.py:29-40) and weights within 1e-6 (absolute; the
    weights are ≤ 1);
  * a lazily appended shard's flushed tree equals the reference's eager
    tree exactly (all priorities 1.0: every sum is exact);
  * the params channel stages on the same polls as the reference's.
Self-equivalence, as the reference asserts it: the 1-shard
``ServiceExecutor`` under ``RateLimiter.from_schedule`` is the port's
``FusedExecutor`` bit for bit (both draw from one torch.Generator, so
there is no JAX trajectory to match)."""

import functools
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.replay import PrioritizedReplay as JReplay
from repro.core.replay import ReplayConfig as JReplayConfig
from repro.serve.params import ParamDoubleBuffer as JParamDoubleBuffer
from repro.serve.params import ServiceParamChannel as JServiceParamChannel
from repro.service import RateLimiter as JRateLimiter
from repro.service import ReplayService as JReplayService
from repro.service import ReplayServiceConfig as JReplayServiceConfig
from repro.service import Router as JRouter
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.quickstart import transition_example
from repro_torch.runtime.executors import FusedExecutor
from repro_torch.runtime.loop import LoopConfig, RatioSchedule
from repro_torch.serve.params import ParamDoubleBuffer, ServiceParamChannel
from repro_torch.service import (RateLimiter, ReplayClient, ReplayService,
                                 ReplayServiceConfig, Router, ServiceExecutor,
                                 ServiceStopped, serve)
from repro_torch.service.server import stratified_sample

torch.set_num_threads(2)

EXAMPLE = {
    "obs": torch.zeros((4,), dtype=torch.float32),
    "action": torch.zeros((), dtype=torch.int32),
    "reward": torch.zeros(()),
    "next_obs": torch.zeros((4,), dtype=torch.float32),
    "done": torch.zeros(()),
}
JEXAMPLE = {k: jnp.zeros(tuple(v.shape), jnp.int32 if v.dtype == torch.int32 else jnp.float32)
            for k, v in EXAMPLE.items()}


def items(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "action": rng.integers(0, 2, n).astype(np.int32),
        "reward": rng.uniform(0, 1, n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "done": np.zeros(n, np.float32),
    }


def service(**kw):
    limiter = kw.pop("rate_limiter", None)
    return ReplayService(ReplayServiceConfig(**kw), EXAMPLE, rate_limiter=limiter,
                         device="cpu")


def params_checksum(agent_state) -> float:
    return float(sum(p.detach().double().abs().sum() for p in agent_state.params.parameters()))


# -- rate limiter ------------------------------------------------------------


def test_rate_limiter_band():
    lim = RateLimiter(samples_per_insert=2.0, min_size_to_sample=10,
                      error_buffer=4.0)
    # below min size: inserts fine, samples blocked
    assert lim.can_insert(10) and not lim.can_sample(1)
    lim.note_insert(10)
    # at min size, debt 0: sample of up to error_buffer admitted
    assert lim.can_sample(4) and not lim.can_sample(5)
    lim.note_sample(4)          # debt -4 — sampler at the band edge
    assert not lim.can_sample(1)
    # writer credit: 1 insert adds spi=2 credit
    lim.note_insert(1)
    assert lim.can_sample(2) and not lim.can_sample(3)
    # writer backpressure: debt -2, insert of b adds 2b credit;
    # 3 ≤ (4+2)/2 admitted, 4 is not
    assert lim.can_insert(3) and not lim.can_insert(4)


def _raises_stopped(lim):
    try:
        lim.await_insert(10_000, timeout=10.0)
        return False
    except ServiceStopped:
        return True


def test_rate_limiter_blocking_and_stop():
    lim = RateLimiter(samples_per_insert=1.0, min_size_to_sample=1,
                      error_buffer=1.0)
    got = []

    def sampler():
        try:
            lim.await_sample(1, timeout=10.0)
            got.append("sampled")
        except ServiceStopped:
            got.append("stopped")

    t = threading.Thread(target=sampler)
    t.start()
    time.sleep(0.05)
    assert got == []            # parked: no inserts yet
    lim.note_insert(2)
    t.join(timeout=5.0)
    assert got == ["sampled"]

    # writers parked in backpressure must wake on stop()
    t2 = threading.Thread(target=lambda: got.append(
        "insert-stopped" if _raises_stopped(lim) else "insert-ok"))
    t2.start()
    time.sleep(0.05)
    lim.stop()
    t2.join(timeout=5.0)
    assert got[-1] == "insert-stopped"


def test_rate_limiter_timeout():
    lim = RateLimiter(samples_per_insert=1.0, min_size_to_sample=1,
                      error_buffer=1.0)
    with pytest.raises(TimeoutError, match="not admitted"):
        lim.await_sample(1, timeout=0.05)


def test_rate_limiter_validation():
    with pytest.raises(ValueError, match="samples_per_insert"):
        RateLimiter(0.0, 1, 1.0)
    with pytest.raises(ValueError, match="min_size_to_sample"):
        RateLimiter(1.0, 0, 1.0)
    with pytest.raises(ValueError, match="deadlock"):
        RateLimiter(4.0, 1, 1.0)
    with pytest.raises(ValueError, match="counts must be"):
        RateLimiter(1.0, 1, 1.0).restore_counts(-1, 0)


def test_from_schedule_reproduces_ratio_cadence():
    """The tight-band limiter admits exactly the RatioSchedule cadence
    under a greedy drain — flow control generalizes the schedule."""
    for cfg, n_envs in [(LoopConfig(batch_size=64, update_interval=1,
                                    warmup=400), 8),
                        (LoopConfig(batch_size=64, update_interval=16,
                                    warmup=384), 8)]:
        sched = RatioSchedule.from_config(cfg, n_envs)
        lim = RateLimiter.from_schedule(sched, cfg.batch_size, cfg.warmup)
        learns_per_window = []
        for w in range(120):
            n = 0
            while lim.can_sample(cfg.batch_size):
                lim.note_sample(cfg.batch_size)
                n += 1
            learns_per_window.append(n)
            lim.note_insert(n_envs)
        expect = [sched.learns
                  if (8 * w >= cfg.warmup and w % sched.period == 0) else 0
                  for w in range(120)]
        assert learns_per_window == expect


# -- router ------------------------------------------------------------------


def test_router_policies():
    r = Router(4, "hash")
    # stable per writer, spread across shards for distinct writers
    assert all(r.route("actor-3") == r.route("actor-3") for _ in range(5))
    assert len({r.route(f"actor-{i}") for i in range(64)}) == 4
    rr = Router(3, "round_robin")
    assert [rr.route("x") for x in range(6)] == [0, 1, 2, 0, 1, 2]
    with pytest.raises(ValueError, match="unknown router policy"):
        Router(2, "modulo")
    with pytest.raises(ValueError, match="n_shards"):
        Router(0)


def test_limiter_and_router_match_reference():
    """One seeded sequence of admissions (insert or sample, of random
    size) through the port's and the reference's limiters: every
    can_insert/can_sample decision, the counts and the realized ratio
    agree exactly; so do both routers' shards over random writer ids, and
    the constructors' bands."""
    rng = np.random.default_rng(11)
    for spi, min_size, eb in [(2.0, 10, 4.0), (8.0, 400, 1024.0), (0.5, 64, 64.0)]:
        ours, ref = RateLimiter(spi, min_size, eb), JRateLimiter(spi, min_size, eb)
        decisions = [], []
        for _ in range(2000):
            b = int(rng.integers(1, 96))
            if rng.uniform() < 0.5:
                for lim, out in zip((ours, ref), decisions):
                    ok = lim.can_insert(b)
                    out.append(("i", b, ok))
                    if ok:
                        lim.note_insert(b)
            else:
                for lim, out in zip((ours, ref), decisions):
                    ok = lim.can_sample(b)
                    out.append(("s", b, ok))
                    if ok:
                        lim.note_sample(b)
        assert decisions[0] == decisions[1]
        assert any(d[2] for d in decisions[0]) and not all(d[2] for d in decisions[0])
        assert ours.stats() == ref.stats()
    for policy in ("hash", "round_robin"):
        for n in (1, 2, 3, 7):
            writers = [f"actor-{int(i)}" for i in rng.integers(0, 1000, 200)]
            a, b = Router(n, policy), JRouter(n, policy)
            assert [a.route(w) for w in writers] == [b.route(w) for w in writers]
    sched = RatioSchedule.from_config(LoopConfig(batch_size=64, update_interval=2), 8)
    from repro.runtime.loop import LoopConfig as JLoopConfig
    from repro.runtime.loop import RatioSchedule as JRatioSchedule
    jsched = JRatioSchedule.from_config(JLoopConfig(batch_size=64, update_interval=2), 8)
    assert (RateLimiter.from_schedule(sched, 64, 400).stats()
            == JRateLimiter.from_schedule(jsched, 64, 400).stats())
    assert (RateLimiter.for_loop(64, 2, 400, insert_burst=128).stats()
            == JRateLimiter.for_loop(64, 2, 400, insert_burst=128).stats())


# -- service core ------------------------------------------------------------


def test_service_append_sample_update_roundtrip():
    svc = service(capacity_per_shard=128, n_shards=2, fanout=8)
    expect = [0, 0]
    for i in range(4):
        out = svc.append(f"w{i}", items(32, seed=i))
        assert not out["stopped"] and out["inserts"] == 32 * (i + 1)
        expect[Router(2, "hash").route(f"w{i}")] += 32
    st = svc.stats()
    assert st["inserts"] == 128 and st["per_shard_count"] == expect
    out = svc.sample(batch=32, beta=0.4)
    assert isinstance(out["items"]["obs"], np.ndarray)
    assert out["items"]["obs"].shape == (32, 4)
    assert out["weights"].shape == (32,) and out["weights"].max() <= 1 + 1e-6
    # one device→host copy a storage leaf, and one for the weights
    assert svc.stats()["sample_host_copies"] == len(EXAMPLE) + 1
    assert svc.update_priorities(out["sample_id"],
                                 np.ones(32, np.float32))["applied"]
    # a second write-back on the same handle is stale, not an error
    assert not svc.update_priorities(out["sample_id"],
                                     np.ones(32, np.float32))["applied"]


def test_service_sample_batch_must_divide_shards():
    svc = service(capacity_per_shard=64, n_shards=3, fanout=8)
    svc.append("w", items(48))
    with pytest.raises(ValueError, match="divide evenly"):
        svc.sample(batch=32)


def test_service_lazy_appends_flush_once_per_window():
    """Appends are leaf-only (pending ledger grows); the sample boundary
    runs ONE propagation pass and the flushed tree equals the eager
    per-op path bit for bit, the port's and the reference's."""
    svc = service(capacity_per_shard=256, n_shards=1, fanout=8, seed=7)
    eager = PrioritizedReplay(ReplayConfig(capacity=256, fanout=8), EXAMPLE, device="cpu")
    jeager = JReplay(JReplayConfig(capacity=256, fanout=8), JEXAMPLE)
    est, jst = eager.init(), jeager.init()
    for i in range(3):
        batch = items(64, seed=i)
        svc.append("w", batch)
        est = eager.insert(est, {k: torch.from_numpy(v) for k, v in batch.items()})
        jst = jeager.insert(jst, jax.tree.map(jnp.asarray, batch))
    assert svc.states[0].pending == 3 * 2 * 64      # begin + commit a row
    flushes = svc.replay.ops.counts["flush"]
    svc.sample(batch=64)                    # the admission window boundary
    assert svc.states[0].pending == 0
    assert svc.replay.ops.counts["flush"] == flushes + 1
    np.testing.assert_array_equal(svc.states[0].tree.numpy(), est.tree.numpy())
    np.testing.assert_array_equal(svc.states[0].tree.numpy(), np.asarray(jst.tree))


def test_service_param_channel():
    svc = service(capacity_per_shard=64)
    assert svc.params_version() == 0
    with pytest.raises(TimeoutError):
        svc.get_params(min_version=1, timeout=0.05)
    v = svc.put_params(pickle.dumps({"w": np.ones(3)}))
    assert v == 1
    out = svc.get_params(min_version=1, timeout=1.0)
    assert out["version"] == 1
    np.testing.assert_array_equal(pickle.loads(out["blob"])["w"], np.ones(3))


def test_service_rate_limited_ratio():
    """2 writer threads + 1 sampler thread against a live service: the
    realized samples-per-insert ratio lands inside the limiter band."""
    lim = RateLimiter(samples_per_insert=0.5, min_size_to_sample=64,
                      error_buffer=64.0)
    svc = service(capacity_per_shard=512, n_shards=2, fanout=8, rate_limiter=lim)
    stop_at = 2048   # inserts target

    def writer(wid):
        i = 0
        while not svc.stopped and svc.total_inserts() < stop_at:
            try:
                svc.append(f"writer-{wid}", items(32, seed=i), timeout=10.0)
            except ServiceStopped:
                return
            i += 1

    def sampler():
        while not svc.stopped:
            out = svc.sample(batch=32, beta=0.4, timeout=10.0)
            if out.get("stopped"):
                return
            svc.update_priorities(out["sample_id"],
                                  np.ones(32, np.float32))

    threads = [threading.Thread(target=writer, args=(w,)) for w in (0, 1)]
    threads.append(threading.Thread(target=sampler))
    for t in threads:
        t.start()
    for t in threads[:2]:
        t.join(timeout=60.0)
    svc.stop()
    threads[2].join(timeout=60.0)
    assert not any(t.is_alive() for t in threads)
    st = lim.stats()
    assert st["inserts"] >= stop_at
    # band: |realized − configured| ≤ error_buffer / (inserts − min_size)
    slack = lim.error_buffer / (st["inserts"] - lim.min_size_to_sample)
    assert abs(st["realized_spi"] - 0.5) <= slack + 1e-6


def test_service_stop_wakes_parked_writers_in_process():
    """Writers parked in rate-limiter backpressure must wake on stop()
    with a stopped (not applied) reply — not hang until timeout."""
    lim = RateLimiter(samples_per_insert=1.0, min_size_to_sample=1,
                      error_buffer=1.0)
    svc = service(capacity_per_shard=256, fanout=8, rate_limiter=lim)
    replies = []

    def writer(wid):
        replies.append(svc.append(f"w{wid}", items(64, seed=wid),
                                  timeout=30.0))

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    assert replies == []            # both parked: 64 ≫ the limiter band
    svc.stop()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert len(replies) == 2
    assert all(r["stopped"] and "applied" not in r for r in replies)


def test_service_stop_wakes_parked_writers_tcp():
    """The same wake-on-stop contract through the wire: appends parked
    server-side return a stopped reply to their TCP clients."""
    lim = RateLimiter(samples_per_insert=1.0, min_size_to_sample=1,
                      error_buffer=1.0)
    svc = service(capacity_per_shard=256, fanout=8, rate_limiter=lim)
    server, port = serve(svc)
    replies = []

    def writer(wid):
        c = ReplayClient("127.0.0.1", port)
        try:
            replies.append(c.append(f"w{wid}", items(64, seed=wid),
                                    timeout=30.0))
        finally:
            c.close()

    try:
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert replies == []
        ctl = ReplayClient("127.0.0.1", port)
        ctl.stop()
        ctl.close()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
        assert len(replies) == 2
        assert all(r["stopped"] and not r.get("applied") for r in replies)
    finally:
        server.shutdown()
        server.server_close()


# -- wire path ---------------------------------------------------------------


def test_tcp_server_client_roundtrip():
    svc = service(capacity_per_shard=256, n_shards=2, fanout=8)
    server, port = serve(svc)
    try:
        c = ReplayClient("127.0.0.1", port)
        assert c.ping()
        # torch tensors cross as numpy
        out = c.append("actor-0", {k: torch.from_numpy(v) for k, v in items(64).items()})
        assert out["inserts"] == 64
        c.put_params({"w": torch.arange(4.0), "h": torch.ones(2, dtype=torch.bfloat16)})
        got = c.get_params(min_version=1, timeout=5.0)
        assert got["version"] == 1
        np.testing.assert_array_equal(got["params"]["w"], np.arange(4.0))
        assert got["params"]["h"].dtype == np.float32     # bf16 widens exactly
        s = c.sample(batch=32)
        assert s["items"]["obs"].shape == (32, 4)
        assert s["items"]["action"].dtype == np.int32
        assert c.update_priorities(s["sample_id"], np.ones(32, np.float32))
        # errors cross the wire as exceptions, not dead connections
        with pytest.raises(RuntimeError, match="divide evenly"):
            c.sample(batch=31)
        assert c.stats()["inserts"] == 64
        c.stop()
        assert svc.stopped
        c.close()
    finally:
        server.shutdown()
        server.server_close()


# -- the stratified sample against the reference ------------------------------


@pytest.mark.parametrize("n_shards,fused", [(1, False), (2, False), (2, True), (4, False)])
def test_stratified_sample_matches_reference(n_shards, fused):
    """The same appends (by the same router) and priority writes on both
    services; the port's ``stratified_sample`` fed the uniforms the
    reference's sample program draws (``fold_in(fold_in(key, call), i)``)
    returns the reference's indices (ties by the rule of
    tests/test_kernels.py:29-40), rows and weights (atol 1e-6)."""
    ours = service(capacity_per_shard=512, n_shards=n_shards, fanout=8, seed=5,
                   fused_sample_gather=fused)
    ref = JReplayService(JReplayServiceConfig(capacity_per_shard=512, n_shards=n_shards,
                                              fanout=8, seed=5, backend="xla",
                                              fused_sample_gather=fused), JEXAMPLE)
    rng = np.random.default_rng(3)
    for i in range(12):
        batch = items(40, seed=100 + i)
        ours.append(f"actor-{i}", batch)
        ref.append(f"actor-{i}", batch)
    assert ours.stats()["per_shard_count"] == ref.stats()["per_shard_count"]
    # spread the priorities: the same TD errors on every written slot
    for s in range(n_shards):
        count = ours.states[s].count
        idx = np.arange(count)
        td = rng.uniform(0, 3, count).astype(np.float32)
        ours.states[s] = ours.replay.update_priorities(
            ours.replay.flush(ours.states[s]), torch.from_numpy(idx), torch.from_numpy(td))
        ref.states[s] = ref.replay.update_priorities(
            ref.replay.flush(ref.states[s]), jnp.asarray(idx), jnp.asarray(td))
    batch, beta = 64, 0.4
    per = batch // n_shards
    out = ref.sample(batch=batch, beta=beta)
    want_idx = ref._outstanding[out["sample_id"]]
    key = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    if n_shards == 1:
        us = [np.asarray(jax.random.uniform(key, (batch,)))]
    else:
        us = [np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (per,)))
              for i in range(n_shards)]
    states = [ours.replay.flush(s) for s in ours.states]
    got_idx, got_items, got_w = stratified_sample(
        ours.replay, states, [torch.from_numpy(np.array(u)) for u in us], beta)
    agree_all = []
    for s in range(n_shards):
        gi, ri = got_idx[s].numpy(), np.asarray(want_idx[s])
        agree = gi == ri
        assert agree.mean() > 0.9
        if not agree.all():
            # disagreements must be fp ties: adjacent leaves whose CDF gap
            # is ≈ eps·total (tests/test_kernels.py:29-40)
            leaves = ours.replay.get_priority(states[s], torch.arange(512)).numpy()
            cdf = np.cumsum(leaves)
            gap = np.abs(cdf[ri[~agree]] - cdf[gi[~agree]])
            assert (gap <= 2e-5 * cdf[-1] + np.maximum(leaves[ri[~agree]],
                                                       leaves[gi[~agree]])).all()
        agree_all.append(agree)
    agree = np.concatenate(agree_all)
    np.testing.assert_allclose(got_w.numpy()[agree], out["weights"][agree], rtol=0, atol=1e-6)
    for k, v in got_items.items():
        np.testing.assert_array_equal(v.numpy()[agree], out["items"][k][agree])


# -- the params channel ---------------------------------------------------------


def test_channel_poll_matches_reference():
    """poll() returns False on an empty channel, stages each new version
    once, never re-stages one it has seen — on the same polls as the
    reference's channel against the reference's service."""
    ours = service(capacity_per_shard=8)
    ref = JReplayService(JReplayServiceConfig(capacity_per_shard=8, n_shards=1),
                         {"obs": jnp.zeros((2,), jnp.float32)})
    bufs = ParamDoubleBuffer({"w": 0}, version=0), JParamDoubleBuffer({"w": 0}, version=0)
    chans = ServiceParamChannel(ours, bufs[0]), JServiceParamChannel(ref, bufs[1])
    script = ["poll", "put", "poll", "poll", "swap", "poll", "put", "put", "poll",
              "swap", "poll"]
    seen = [], []
    for w, op in enumerate(script):
        for svc, buf, chan, out in zip((ours, ref), bufs, chans, seen):
            if op == "put":
                svc.put_params(pickle.dumps({"w": w}))
            elif op == "poll":
                out.append(("poll", chan.poll(), buf.staged_version))
            else:
                live, v, swapped = buf.swap_if_staged()
                out.append(("swap", live, v, swapped))
    assert seen[0] == seen[1]
    assert ("swap", {"w": 7}, 3, True) in seen[0]
    ref.stop()
    with pytest.raises(TypeError, match="get_params"):
        ServiceParamChannel(object(), ParamDoubleBuffer({}, version=0))


def test_channel_publishes_under_traffic():
    """An ActorServer at granite_8b SMOKE (f32) whose ``param_source`` is a
    ReplayService: a version put mid-run (the learner's numpy state_dict)
    is swapped in at a step boundary, as a copy of the model; requests
    that finish after it carry it."""
    from repro_torch.configs import get_config
    from repro_torch.models import backbone
    from repro_torch.serve import ActorServeConfig, ActorServer
    from repro_torch.service.client import as_numpy

    cfg = get_config("granite_8b", smoke=True)
    model = backbone.init_params(cfg, torch.Generator().manual_seed(0))
    fresh = backbone.init_params(cfg, torch.Generator().manual_seed(1))
    svc = ReplayService(ReplayServiceConfig(capacity_per_shard=8), {"obs": np.zeros((2,), np.float32)},
                        device="cpu")
    server = ActorServer(cfg, model, ActorServeConfig(slots=2, max_len=12, buckets=(4,),
                                                      max_new_tokens=4, idle_wait_s=0.005),
                         params_version=0, param_source=svc, device="cpu")
    try:
        server.start()
        rng = np.random.RandomState(5)
        for h in [server.submit(rng.randint(0, cfg.vocab_size, size=3)) for _ in range(3)]:
            h.result(timeout=120.0)
        svc.put_params(pickle.dumps(as_numpy(fresh)))      # learner-side publish
        done = [h.result(timeout=120.0) for h in
                [server.submit(rng.randint(0, cfg.vocab_size, size=3)) for _ in range(3)]]
        stats = server.stats()
        assert stats["params_version"] == 1 and stats["param_swaps"] == 1
        assert stats["completed"] == 6 and stats["generated_tokens"] == 6 * 4
        assert any(c.params_version == 1 for c in done)
        live, _, _ = server.params.swap_if_staged()
        assert live is not model and live is not fresh
        for (k, a), b in zip(live.state_dict().items(), fresh.state_dict().values()):
            assert torch.equal(a, b), k
        assert server.channel.stats()["outages"] == 0
    finally:
        server.stop()
        svc.stop()


# -- in-process service executor ---------------------------------------------


def _dqn_setup():
    env_fn = functools.partial(make_vec, "cartpole")
    spec, _, _ = env_fn(1)
    return env_fn, spec, make_dqn(spec, DQNConfig())


def test_service_executor_bit_exact_vs_fused():
    """The acceptance contract: a 1-shard in-process service at the
    loop-derived rate limit is FusedExecutor bit for bit — same seed,
    every parameter, the observations and the loss history."""
    env_fn, spec, agent = _dqn_setup()
    cfg = LoopConfig(batch_size=32, warmup=64, epsilon=0.3,
                     update_interval=1, epsilon_decay_steps=500)
    iters = 40
    replay = PrioritizedReplay(ReplayConfig(capacity=1024, fanout=8),
                               transition_example(spec), device="cpu")
    fused = FusedExecutor(agent, replay, env_fn, cfg, n_envs=8, scan_chunk=16,
                          device="cpu")
    f_state, f_hist = fused.train(iters, 3)

    svc = ReplayService(ReplayServiceConfig(capacity_per_shard=1024, n_shards=1, fanout=8),
                        transition_example(spec), device="cpu")
    ex = ServiceExecutor(agent, svc, env_fn, cfg, n_envs=8, scan_chunk=16)
    s_state, s_hist = ex.train(iters, 3)

    assert s_state.learn_steps == f_state.learn_steps > 0
    for a, b in zip(s_state.agent.params.parameters(), f_state.agent.params.parameters()):
        assert torch.equal(a, b)
    assert params_checksum(s_state.agent) == params_checksum(f_state.agent)
    assert torch.equal(s_state.obs, f_state.obs)
    assert torch.equal(s_state.replay[0].tree, f_state.replay.tree)
    for k in f_hist:
        assert torch.equal(s_hist[k], f_hist[k]), k
    # the limiter realized exactly the loop's samples-per-insert ratio
    realized = ex.realized_samples_per_insert()
    assert realized == pytest.approx(cfg.batch_size / cfg.update_interval, rel=0.05)


def test_service_executor_multi_shard_trains():
    """2-shard service: windows route round-robin across shards, learner
    samples stratified with globally-normalized weights — training runs
    and both shards fill."""
    env_fn, spec, agent = _dqn_setup()
    cfg = LoopConfig(batch_size=32, warmup=64, epsilon=0.3,
                     update_interval=2, epsilon_decay_steps=500)
    svc = ReplayService(ReplayServiceConfig(capacity_per_shard=512, n_shards=2, fanout=8,
                                            router="round_robin"),
                        transition_example(spec), device="cpu")
    ex = ServiceExecutor(agent, svc, env_fn, cfg, n_envs=8, scan_chunk=16)
    state, hist = ex.train(48, 0)
    assert state.learn_steps > 0
    assert torch.isfinite(hist["loss"]).all()
    counts = [s.count for s in state.replay]
    assert len(counts) == 2 and min(counts) > 0
    assert abs(counts[0] - counts[1]) <= 8   # round-robin balance
    with pytest.raises(ValueError, match="divide evenly"):
        ServiceExecutor(agent, ReplayService(ReplayServiceConfig(capacity_per_shard=64,
                                                                 n_shards=3),
                                             transition_example(spec), device="cpu"),
                        env_fn, cfg, n_envs=8)
