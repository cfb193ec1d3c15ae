"""The port's replay-service gang (repro_torch.launch.multiprocess +
repro_torch.service, DESIGN.md §11) on the CPU: real OS processes — 1
replay server + 2 actor writers + 1 learner — train CartPole end to end
through the TCP service boundary, at the reference's settings and run
length (tests/test_service_gang.py; 1,400 learn steps, not cut).

Held to the reference's bars: the near-greedy eval return of the
learner's final params beats 30 (tests/test_system.py's criterion), and
the rate limiter's band theorem holds across process boundaries,
|realized_spi − configured_spi| ≤ the server's printed tolerance
(error_buffer / (inserts − min)), held in its exact integer form.  JAX's and torch's random streams
differ, so the trajectory is not compared.  The restart drills are in
tests/test_torch_service_restart.py (a file of their own, so that
``--dist loadfile`` runs them beside these)."""

import pytest

from repro_torch.launch import multiprocess as mp

# the proven in-process hyperparameters of tests/test_system.py, recast
# as explicit flow control: 1400 learns of batch 64 over ~11200 env
# steps ⇒ samples_per_insert = learns·batch/steps = 8
GANG = dict(n_actors=2, samples_per_insert=8.0, batch_size=64,
            warmup=400, n_envs=8, actor_chunk=8, epsilon=0.2, seed=1,
            device="cpu")


def assert_spi_band(kv):
    """|realized − configured spi| ≤ error_buffer / (inserts − min), held
    in its exact form |samples − spi·(inserts − min)| ≤ error_buffer (the
    counts are integers, spi and the buffer exact in f64): a run that ends
    with its debt at the band's edge rounds the ratio form past its
    tolerance by an ulp."""
    spi, eb = float(kv["CONFIGURED_SPI"]), float(kv["ERROR_BUFFER"])
    past = int(kv["INSERTS"]) - int(kv["MIN_SIZE_TO_SAMPLE"])
    debt = int(kv["SAMPLES"]) - spi * past
    assert abs(debt) <= eb, (kv["REALIZED_SPI"], spi, kv["SPI_TOLERANCE"], debt, eb)
    assert float(kv["SPI_TOLERANCE"]) == eb / past


def test_service_gang_trains_cartpole():
    res = mp.launch_service(learn_steps=1400, timeout_s=540.0, **GANG)

    server, learner = res["server"], res["learner"]
    assert server["DEVICE"] == learner["DEVICE"] == "cpu"
    assert server["TREE_BACKEND"] == "torch"
    assert_spi_band(server)
    # counters agree across the boundary: the server's limiter totals are
    # what the learner saw in its final stats round trip
    assert server["INSERTS"] == learner["SERVICE_INSERTS"]
    assert server["SAMPLES"] == learner["SERVICE_SAMPLES"]
    assert int(learner["LEARN_STEPS"]) == 1400
    assert int(server["SAMPLES"]) == 1400 * GANG["batch_size"]
    assert int(server["SAMPLE_CALLS"]) == 1400
    # the wire's host copies: five storage leaves and the weights a sample
    assert int(server["SAMPLE_HOST_COPIES"]) == 1400 * 6
    # on the CPU the plain versions run: no kernel launched
    assert all(int(server[f"LAUNCH_{k}"]) == 0
               for k in ("SUMTREE_SAMPLE", "GATHER", "SAMPLE_GATHER", "SUMTREE_UPDATE"))
    # every transition the actors shipped landed in the (single) shard;
    # the server may hold up to one extra in-flight chunk per actor
    # (admitted between the learner's stop and the actor observing it)
    appended = sum(int(res[f"actor-{a}"]["TRANSITIONS"])
                   for a in range(GANG["n_actors"]))
    burst = GANG["actor_chunk"] * GANG["n_envs"]
    inserts = int(server["INSERTS"])
    assert appended <= inserts <= appended + GANG["n_actors"] * burst
    assert int(server["PER_SHARD_COUNT"]) == inserts
    # both writers made real progress (no actor starved by backpressure)
    for a in range(GANG["n_actors"]):
        assert int(res[f"actor-{a}"]["CHUNKS"]) > 10, res[f"actor-{a}"]
        assert int(res[f"actor-{a}"]["PARAMS_VERSION"]) > 1
    assert float(learner["WALL_PER_LEARN_MS"]) > 0
    # the learning criterion of tests/test_system.py, through the service
    assert float(learner["EVAL_RETURN"]) > 30.0, learner


def test_launch_service_validates_inputs():
    with pytest.raises(ValueError, match="n_actors"):
        mp.launch_service(n_actors=0, device="cpu")
    with pytest.raises(ValueError, match="restart_learner_after"):
        mp.launch_service(n_actors=1, restart_learner_after=10, device="cpu")
    with pytest.raises(ValueError, match="restart_server_after"):
        mp.launch_service(n_actors=1, restart_server_after=10, device="cpu")


def test_dead_role_ends_the_gang():
    """A role that dies takes the gang down with its output tail instead
    of leaving the others parked in backpressure: here the learner, whose
    batch of 64 does not divide over 3 shards (the server refuses the
    sample, the learner raises)."""
    gang = dict(GANG, n_actors=1)
    with pytest.raises(RuntimeError, match="(?s)learner failed.*divide evenly"):
        mp.launch_service(n_shards=3, learn_steps=50, timeout_s=120.0, **gang)
