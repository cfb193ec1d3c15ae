"""The port's fault-tolerant service fabric (repro_torch.service, DESIGN.md
§14) against the JAX package's, on the CPU: deterministic fault
injection, reconnecting clients with idempotent appends, and restart
from shard snapshots — drilled in-process, every failure mode in
seconds (the hard crash across real processes is in
tests/test_torch_service_restart.py).

The scenarios of tests/test_faults.py, each on the port:

  * retry-after-drop is **bit-identical**: the same append stream with
    injected connection drops (request-lost and reply-lost flavors)
    lands the exact same shard state as the clean run — zero duplicate
    inserts, per-writer applied counters equal;
  * a soft crash-on-Kth-append + restore-from-snapshot round trip
    preserves exactly-once across the restart (the shard tensors, the
    sample generator and the host-int head/count/pending restored);
  * retry budgets are bounded (deadline-exceeded raises a typed,
    operator-readable ConnectionError) and the param channel degrades
    to last-good params instead of taking its caller down.

Held against the reference, exactly: the copied ``FaultPlan.parse``,
the injectors' decisions on one seeded frame sequence, and the jittered
backoff schedule; and the drop drill's shard storage equals the
reference service's after the same appends (its tree too, all
priorities being 1.0)."""

import random
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.service import ClientFaultInjector as JClientFaultInjector
from repro.service import FaultPlan as JFaultPlan
from repro.service import ReplayService as JReplayService
from repro.service import ReplayServiceConfig as JReplayServiceConfig
from repro.service import ServerFaultInjector as JServerFaultInjector
from repro.service import RetryPolicy as JRetryPolicy
from repro.service import backoff_delays as jbackoff_delays
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.serve.params import ParamDoubleBuffer, ServiceParamChannel
from repro_torch.service import (ClientFaultInjector, ConnectionClosed, FaultPlan,
                                 ReplayClient, ReplayService, ReplayServiceConfig,
                                 RetryPolicy, ServerFaultInjector, backoff_delays,
                                 serve, wait_for_service)
from repro_torch.service.server import recv_msg

torch.set_num_threads(2)

EXAMPLE = {
    "obs": torch.zeros((4,), dtype=torch.float32),
    "action": torch.zeros((), dtype=torch.int32),
    "reward": torch.zeros(()),
    "next_obs": torch.zeros((4,), dtype=torch.float32),
    "done": torch.zeros(()),
}
JEXAMPLE = {
    "obs": jnp.zeros((4,), jnp.float32),
    "action": jnp.zeros((), jnp.int32),
    "reward": jnp.zeros(()),
    "next_obs": jnp.zeros((4,), jnp.float32),
    "done": jnp.zeros(()),
}


def items(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "action": rng.integers(0, 2, n).astype(np.int32),
        "reward": rng.uniform(0, 1, n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "done": np.zeros(n, np.float32),
    }


FAST_RETRY = dict(base=0.01, cap=0.05, jitter=0.25, deadline=30.0)


def _service(n_shards=1, capacity=4096):
    return ReplayService(
        ReplayServiceConfig(capacity_per_shard=capacity, n_shards=n_shards,
                            fanout=8, seed=5), EXAMPLE, device="cpu")


# -- FaultPlan ---------------------------------------------------------------


def test_fault_plan_parse_and_validation():
    plan = FaultPlan.parse("drop_after_frames=3,drop_before_send=1,"
                           "crash_on_op=append:40,hard=true,seed=7")
    assert plan.drop_after_frames == 3 and plan.drop_before_send
    assert plan.crash_target == ("append", 40) and plan.hard
    assert plan.seed == 7
    assert FaultPlan.parse("").crash_target is None
    with pytest.raises(ValueError, match="unknown fault plan field"):
        FaultPlan.parse("explode=1")
    with pytest.raises(ValueError, match="key=value"):
        FaultPlan.parse("drop_after_frames")
    with pytest.raises(ValueError, match="cmd:K"):
        FaultPlan(crash_on_op="append")
    with pytest.raises(ValueError, match="must be ≥ 1"):
        FaultPlan(crash_on_op="append:0")
    with pytest.raises(ValueError, match="drop_prob"):
        FaultPlan(drop_prob=1.5)
    # crashes are a server-side fault: the client injector refuses them
    with pytest.raises(ValueError, match="server-side"):
        ClientFaultInjector(FaultPlan(crash_on_op="append:1"))


def test_backoff_delays_seeded_and_capped():
    pol = RetryPolicy(base=0.1, cap=1.0, factor=2.0, jitter=0.5, seed=11)
    a = [next(d) for d in [backoff_delays(pol, random.Random(11))]
         for _ in range(12)]
    b = [next(d) for d in [backoff_delays(pol, random.Random(11))]
         for _ in range(12)]
    assert a == b                                   # seeded: replayable
    assert all(x <= pol.cap * (1 + pol.jitter) for x in a)
    assert a[0] <= pol.base * (1 + pol.jitter)      # starts at base
    assert max(a) > pol.cap * (1 - pol.jitter)      # reaches the cap band
    with pytest.raises(ValueError, match="base"):
        RetryPolicy(base=0.0)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=1.0)
    with pytest.raises(ValueError, match="deadline"):
        RetryPolicy(deadline=-1.0)


# -- typed connection teardown ----------------------------------------------


def test_connection_closed_reports_progress():
    a, b = socket.socketpair()
    b.close()
    with pytest.raises(ConnectionClosed, match="closed connection before "
                                               "a frame"):
        recv_msg(a)
    a.close()
    a, b = socket.socketpair()
    b.sendall(b"\x00\x00\x00\x00")      # half of the 8-byte length prefix
    b.close()
    with pytest.raises(ConnectionClosed,
                       match=r"mid-frame \(4/8 bytes read\)") as ei:
        recv_msg(a)
    assert ei.value.bytes_read == 4 and ei.value.expected == 8
    a.close()


# -- idempotent appends under injected drops --------------------------------


def _run_append_stream(plan, chunks=20, chunk=64):
    """Drive one writer's full append stream through a served instance
    under ``plan``; returns (shard leaves, server stats, client)."""
    svc = _service()
    server, port = serve(svc, fault_plan=plan)
    client = ReplayClient("127.0.0.1", port,
                          retry=RetryPolicy(seed=3, **FAST_RETRY))
    try:
        for c in range(chunks):
            reply = client.append("w0", items(chunk, seed=c), timeout=30.0)
            assert reply["applied"]
        leaves = [x.numpy().copy() for x in
                  (svc.states[0].storage["obs"], svc.states[0].tree)]
        return leaves, svc.stats(), client
    finally:
        client.close()
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("plan,expect_dedup", [
    (None, False),
    # reply lost after apply: the retry MUST be deduplicated
    (FaultPlan(drop_after_frames=3), True),
    # request lost before dispatch: the retry is the first application
    (FaultPlan(drop_after_frames=4, drop_before_send=True), False),
])
def test_append_retry_lands_exactly_once(plan, expect_dedup):
    clean, clean_stats, _ = _run_append_stream(None)
    leaves, stats, client = _run_append_stream(plan)
    assert stats["inserts"] == clean_stats["inserts"] == 20 * 64
    assert stats["writer_appends"] == {"w0": 20}
    assert client.acked_appends == 20
    for got, want in zip(leaves, clean):
        np.testing.assert_array_equal(got, want)     # bit-identical
    if plan is not None:
        assert client.reconnects > 0
        assert (client.deduped_appends > 0) == expect_dedup
        assert stats["dup_appends"] == client.deduped_appends


def test_sample_and_update_survive_reply_drops():
    """A retried sample is a fresh draw; a priority write-back on an
    orphaned handle is stale (applied=False), never an error."""
    svc = _service()
    server, port = serve(svc, fault_plan=FaultPlan(drop_after_frames=5))
    client = ReplayClient("127.0.0.1", port,
                          retry=RetryPolicy(seed=1, **FAST_RETRY))
    try:
        client.append("w0", items(256), timeout=30.0)
        seen = set()
        for _ in range(12):
            out = client.sample(batch=32)
            assert out["items"]["obs"].shape == (32, 4)
            assert out["sample_id"] not in seen      # every draw is fresh
            seen.add(out["sample_id"])
            client.update_priorities(out["sample_id"],
                                     np.ones(32, np.float32))
        assert client.reconnects > 0
    finally:
        client.close()
        server.shutdown()
        server.server_close()


# -- crash + restore ---------------------------------------------------------


def test_soft_crash_restore_is_exactly_once(tmp_path):
    """Crash-on-6th-append tears down the live server; a replacement
    restores the per-append snapshot onto the same port and the writer's
    retried stream lands exactly once across the restart."""
    manager = CheckpointManager(str(tmp_path), keep=2)
    svc = _service()
    svc.attach_snapshots(manager, every_appends=1)
    server, port = serve(svc, fault_plan=FaultPlan(crash_on_op="append:6"))
    restored = {}

    def monitor():
        server.crashed.wait(timeout=60.0)
        svc2 = _service()
        restored["step"] = svc2.restore_snapshot(
            CheckpointManager(str(tmp_path), keep=2))
        svc2.attach_snapshots(CheckpointManager(str(tmp_path), keep=2),
                              every_appends=1)
        restored["server"], _ = serve(svc2, port=port)
        restored["service"] = svc2

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()
    client = ReplayClient("127.0.0.1", port,
                          retry=RetryPolicy(seed=2, **FAST_RETRY))
    try:
        for c in range(12):
            assert client.append("w0", items(64, seed=c),
                                 timeout=30.0)["applied"]
        mon.join(timeout=60.0)
        st = restored["service"].stats()
        assert restored["step"] is not None
        assert st["restored_step"] == restored["step"]
        assert st["inserts"] == 12 * 64              # exactly once
        assert st["writer_appends"] == {"w0": 12}
        assert client.acked_appends == 12
        assert client.reconnects >= 1
    finally:
        client.close()
        server.server_close()
        if "server" in restored:
            restored["server"].shutdown()
            restored["server"].server_close()


def test_restore_snapshot_without_snapshots_returns_none(tmp_path):
    svc = _service()
    assert svc.restore_snapshot(CheckpointManager(str(tmp_path))) is None


# -- bounded retry ------------------------------------------------------------


def test_retry_deadline_exceeded_is_typed_and_bounded():
    svc = _service()
    server, port = serve(svc)
    client = ReplayClient("127.0.0.1", port,
                          retry=RetryPolicy(base=0.01, cap=0.05,
                                            deadline=1.0))
    assert client.ping()
    server.simulate_crash()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError,
                       match=r"'ping' still failing after .* "
                             r"\(deadline 1s\)"):
        client.ping()
    assert time.monotonic() - t0 < 10.0             # bounded, not hung
    client.close()
    server.server_close()


def test_client_side_injected_drops_are_retried():
    svc = _service()
    server, port = serve(svc)
    client = ReplayClient("127.0.0.1", port,
                          retry=RetryPolicy(seed=4, **FAST_RETRY),
                          fault_plan=FaultPlan(drop_after_frames=3))
    try:
        for c in range(8):
            assert client.append("w0", items(16, seed=c),
                                 timeout=30.0)["applied"]
        assert svc.stats()["inserts"] == 8 * 16      # exactly once
        assert client.reconnects > 0
    finally:
        client.close()
        server.shutdown()
        server.server_close()


def test_wait_for_service_deadline_message():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()                                    # nobody listening now
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=rf"replay service at 127.0.0.1:{port} not "
                             rf"reachable within 1s"):
        wait_for_service("127.0.0.1", port, timeout=1.0)
    assert time.monotonic() - t0 < 10.0


# -- graceful degradation -----------------------------------------------------


def test_param_channel_degrades_through_outage():
    svc = _service()
    server, port = serve(svc)
    client = ReplayClient("127.0.0.1", port,
                          retry=RetryPolicy(base=0.01, cap=0.02,
                                            deadline=0.2))
    buf = ParamDoubleBuffer({"w": np.zeros(3)}, version=0)
    chan = ServiceParamChannel(client, buf)
    client.put_params({"w": np.ones(3)})
    assert chan.poll()
    params, version, _ = buf.swap_if_staged()
    assert version == 1 and chan.stale_polls == 0

    server.simulate_crash()                          # outage begins
    for k in range(1, 4):
        assert not chan.poll()
        assert chan.outages == k and chan.stale_polls == k
    assert chan.last_error is not None
    # last-good params stay live throughout the outage
    live, v, swapped = buf.swap_if_staged()
    assert v == 1 and not swapped
    np.testing.assert_array_equal(live["w"], np.ones(3))
    server.server_close()

    svc2 = _service()
    server2, _ = serve(svc2, port=port)              # service returns
    try:
        ctl = ReplayClient("127.0.0.1", port)
        ctl.put_params({"w": np.full(3, 2.0)})
        ctl.put_params({"w": np.full(3, 3.0)})       # version 2 on svc2
        assert chan.poll()                           # recovery resets
        assert chan.stale_polls == 0
        _, v2, swapped = buf.swap_if_staged()
        assert swapped and v2 == 2
        ctl.close()
    finally:
        client.close()
        server2.shutdown()
        server2.server_close()


# -- against the reference -----------------------------------------------------


def test_fault_plan_and_injectors_match_reference():
    """The copied plan parser, both injectors and the backoff schedule
    make the reference's decisions on one seeded sequence of frames."""
    specs = ["drop_after_frames=3,drop_before_send=1,crash_on_op=append:40,hard=true,seed=7",
             "drop_prob=0.3,seed=11", "drop_after_frames=4,drop_prob=0.1,seed=2",
             "delay_reply_s=0.0,delay_every=3", ""]
    rng = np.random.default_rng(0)
    cmds = [["append", "sample", "update_priorities", "get_params"][int(i)]
            for i in rng.integers(0, 4, 300)]
    conns = [int(c) for c in rng.integers(0, 3, 300)]
    for spec in specs:
        ours, ref = FaultPlan.parse(spec), JFaultPlan.parse(spec)
        assert ours.__dict__ == ref.__dict__
        si, ji = ServerFaultInjector(ours), JServerFaultInjector(ref)
        assert ([si.on_frame(c, cmd) for c, cmd in zip(conns, cmds)]
                == [ji.on_frame(c, cmd) for c, cmd in zip(conns, cmds)])
        assert si.dropped == ji.dropped
        if not ours.crash_on_op:
            ci, jci = ClientFaultInjector(ours), JClientFaultInjector(ref)
            assert [ci.on_request(c) for c in cmds] == [jci.on_request(c) for c in cmds]
    pol = RetryPolicy(base=0.05, cap=2.0, factor=2.0, jitter=0.5, seed=9)
    jpol = JRetryPolicy(base=0.05, cap=2.0, factor=2.0, jitter=0.5, seed=9)
    a, b = backoff_delays(pol, random.Random(9)), jbackoff_delays(jpol, random.Random(9))
    assert [next(a) for _ in range(20)] == [next(b) for _ in range(20)]


def test_drop_drill_lands_the_reference_state():
    """The reply-lost drill (drop every 3rd frame) leaves the port's shard
    exactly as the reference service's after the same 20 appends: storage
    bit for bit, and the tree (every priority 1.0, every sum exact)."""
    leaves, stats, _ = _run_append_stream(FaultPlan(drop_after_frames=3))
    ref = JReplayService(JReplayServiceConfig(capacity_per_shard=4096, n_shards=1,
                                              fanout=8, seed=5), JEXAMPLE)
    for c in range(20):
        ref.append("w0", items(64, seed=c))
    ref.sample(batch=32)                    # the reference flushes at its sample
    obs, tree = leaves
    np.testing.assert_array_equal(obs, np.asarray(ref.states[0].storage["obs"]))
    svc = _service()
    for c in range(20):
        svc.append("w0", items(64, seed=c))
    svc.sample(batch=32)
    np.testing.assert_array_equal(svc.states[0].tree.numpy(), np.asarray(ref.states[0].tree))
    assert stats["inserts"] == ref.stats()["inserts"] == 20 * 64
