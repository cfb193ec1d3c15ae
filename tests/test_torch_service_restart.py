"""The port's replay-service gang through its two restart drills, on the
CPU (tests/test_service_gang.py's drills, at its settings): the learner
exits mid-run and a fresh process resumes from its checkpoint against
the live service; the server is hard-killed (``os._exit(42)``) at its
40th append and a fresh one restores its snapshot onto the same port.

Held to the reference's bars: the learn count continues where it
stopped; the band theorem |realized − configured spi| ≤ the server's
tolerance holds through either gap; exactly-once across the server
crash — every actor's acked appends equal the restored server's applied
count for it; the eval return beats 30 after the server drill's 1,400
learn steps (tests/test_system.py's criterion)."""

from test_torch_service_gang import GANG, assert_spi_band  # noqa: E402 — sibling test module (pytest rootdir import)

from repro_torch.launch import multiprocess as mp


def test_service_gang_learner_restart_resumes_from_checkpoint(tmp_path):
    res = mp.launch_service(learn_steps=800, timeout_s=540.0,
                            ckpt_dir=str(tmp_path), ckpt_every=100,
                            restart_learner_after=300, **GANG)

    first, resumed = res["learner-0"], res["learner"]
    assert first["EXITED_EARLY"] == "1"
    assert int(first["LEARN_STEPS"]) == 300
    assert int(resumed["RESUMED_FROM"]) == 300
    assert int(resumed["LEARN_STEPS"]) == 800
    # the service survived the learner gap: one continuous limiter
    # history, still inside the band, with both actors running throughout
    assert_spi_band(res["server"])
    assert int(res["server"]["SAMPLES"]) == 800 * GANG["batch_size"]
    for a in range(GANG["n_actors"]):
        assert int(res[f"actor-{a}"]["CHUNKS"]) > 10, res[f"actor-{a}"]


def test_service_gang_server_restart_restores_from_snapshot(tmp_path):
    """The server is the casualty (DESIGN.md §14): a fault plan hard-kills
    it at its 40th append, actors and learner park in reconnect backoff,
    a replacement restores the per-append shard snapshot onto the same
    port, and training runs through the fault to the same learning
    criterion.  Exactly-once is asserted as *identical counters*: every
    actor's acked-append count equals the restored server's per-writer
    applied table — zero duplicate inserts across the crash."""
    res = mp.launch_service(learn_steps=1400, timeout_s=600.0,
                            snapshot_dir=str(tmp_path),
                            snapshot_every_appends=1,
                            restart_server_after=40,
                            retry_deadline=240.0, **GANG)

    server, learner = res["server"], res["learner"]
    assert int(server["RESTORED_STEP"]) >= 1
    assert int(server["SNAPSHOTS"]) >= 1
    # per-writer exactly-once across the restart: the client-side ack
    # count IS the server-side applied count, for every actor
    applied = dict(kv.split(":") for kv in
                   server["WRITER_APPENDS"].split(","))
    for a in range(GANG["n_actors"]):
        actor = res[f"actor-{a}"]
        assert int(actor["ACKED_APPENDS"]) == int(applied[f"actor-{a}"]), (
            actor, server)
        # the fault really hit this writer's connection
        assert int(actor["RECONNECTS"]) >= 1, actor
    # duplicates were *detected* (and not applied); the server may have
    # lost pre-crash dedup-ack counts that clients kept, never the
    # reverse
    deduped = sum(int(res[f"actor-{a}"]["DEDUPED_APPENDS"])
                  for a in range(GANG["n_actors"]))
    assert int(server["DUP_APPENDS"]) <= deduped
    # one continuous limiter history through the crash, inside the band
    assert_spi_band(server)
    assert int(learner["LEARN_STEPS"]) == 1400
    # the learning criterion of tests/test_system.py, through the fault
    assert float(learner["EVAL_RETURN"]) > 30.0, learner
