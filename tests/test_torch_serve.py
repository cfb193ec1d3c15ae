"""The port's continuous-batching actor server (repro_torch.serve) against
the JAX package's (repro.serve), on the CPU, at ``granite_8b`` SMOKE in
f32 with the reference's parameters carried across.

The scenarios of tests/test_serve.py, each held to the reference: the
same greedy tokens from the engine and scheduler on the same traffic;
continuous batching ≡ solo greedy decodes; the slot-mask freeze; exact
token accounting (budget-1 requests included); prefill shapes bounded by
the bucket set (the reference's retrace count); one params version per
decode step; finished slots reused.  The per-slot position vector that
replaces the reference's vmap is held directly: a batched decode with
rows at different depths against the reference's batch-of-1 decode of
each row (atol 1e-5, rtol 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import backbone as jb
from repro.models.config import NO_SHARDING
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import DecodeEngine as JDecodeEngine
from repro.serve import Scheduler as JScheduler
from repro_torch import interop, serve_actor
from repro_torch.configs import get_config
from repro_torch.models import backbone as tb
from repro_torch.serve import (ActorServeConfig, ActorServer, BucketSpec,
                               DecodeEngine, Scheduler)

torch.set_num_threads(2)

# (prompt length, budget): buckets 4 and 8, two budget-1 requests, more
# requests than slots so finished slots are reused
TRAFFIC = [(3, 6), (6, 4), (5, 1), (1, 5), (4, 2), (8, 3), (2, 1)]
BUCKETS, SLOTS, MAX_LEN = (4, 8), 2, 16


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jget_config("granite_8b", smoke=True), get_config("granite_8b", smoke=True)
    params = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, params, interop.backbone_params_from_numpy(tcfg, params)


def prompts(seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=n).astype(np.int32) for n, _ in TRAFFIC]


def drain(sched, params, version=0, max_steps=500):
    out = []
    for _ in range(max_steps):
        if not sched.busy:
            return out
        out.extend(sched.serve_step(params, version))
    raise AssertionError(f"scheduler did not drain in {max_steps} steps")


@pytest.fixture(scope="module")
def both_runs(smoke):
    jcfg, tcfg, params, model = smoke
    runs = {}
    for name, sched, p in (
            ("ref", JScheduler(JDecodeEngine(jcfg, slots=SLOTS, max_len=MAX_LEN,
                                             buckets=JBucketSpec(BUCKETS))), params),
            ("port", Scheduler(DecodeEngine(tcfg, slots=SLOTS, max_len=MAX_LEN,
                                            buckets=BucketSpec(BUCKETS), device="cpu")),
             model)):
        for prompt, (_, budget) in zip(prompts(), TRAFFIC):
            sched.submit(prompt, budget)
        runs[name] = (sched, {c.rid: c for c in drain(sched, p)})
    return runs


def solo_greedy(tcfg, model, prompt, n_tokens, max_len):
    """Exact-length prefill + plain decode loop, batch 1."""
    logits, cache = tb.prefill(tcfg, model, torch.from_numpy(prompt).long()[None], max_len)
    out = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n_tokens - 1):
        lg, cache = tb.decode_step(tcfg, model, cache, torch.tensor([[out[-1]]]))
        out.append(int(torch.argmax(lg[0, -1])))
    return out


# -- buckets and admission ------------------------------------------------------


def test_buckets_match_reference():
    spec, ref = BucketSpec((4, 8, 32)), JBucketSpec((4, 8, 32))
    for n in (1, 4, 5, 8, 9, 32):
        assert spec.bucket_for(n) == ref.bucket_for(n)
        p = np.arange(1, n + 1, dtype=np.int32)
        np.testing.assert_array_equal(spec.pad(p), ref.pad(p))
    for bad in ((), (8, 4), (4, 4)):
        with pytest.raises(ValueError):
            BucketSpec(bad)
    with pytest.raises(ValueError, match="exceeds the largest bucket edge"):
        spec.bucket_for(33)


def test_engine_admission_checks(smoke):
    _, tcfg, _, _ = smoke
    with pytest.raises(ValueError, match="exceeds.*max_len"):
        DecodeEngine(tcfg, slots=1, max_len=4, buckets=BucketSpec((8,)), device="cpu")
    eng = DecodeEngine(tcfg, slots=1, max_len=8, buckets=BucketSpec((4,)), device="cpu")
    eng.fits(4, 5)                      # last write at position 7: fits
    with pytest.raises(ValueError, match="overrun the KV cache"):
        eng.fits(4, 6)
    with pytest.raises(ValueError, match="exceeds the largest bucket edge"):
        eng.fits(5, 1)
    with pytest.raises(ValueError, match="must be >= 1"):
        eng.fits(4, 0)
    import dataclasses
    with pytest.raises(ValueError, match="pad-then-rewind"):
        DecodeEngine(dataclasses.replace(tcfg, family="ssm"), slots=1, max_len=8,
                     buckets=BucketSpec((4,)), device="cpu")


# -- the engine and scheduler against the reference ------------------------------


def test_scheduler_tokens_match_reference(both_runs):
    ref, port = both_runs["ref"][1], both_runs["port"][1]
    assert sorted(port) == sorted(ref) == list(range(len(TRAFFIC)))
    for rid in ref:
        assert port[rid].tokens == ref[rid].tokens, rid
        assert port[rid].slot == ref[rid].slot and port[rid].prompt_len == ref[rid].prompt_len


def test_slots_reused_and_logs_match_reference(both_runs):
    ref, port = both_runs["ref"][0], both_runs["port"][0]
    assert list(port.admission_log) == list(ref.admission_log)
    assert list(port.step_log) == list(ref.step_log)
    admitted = [slot for _, slot, _ in port.admission_log]
    assert len(admitted) == len(TRAFFIC) > SLOTS and set(admitted) == set(range(SLOTS))


def test_prime_shapes_bounded_by_buckets(both_runs):
    ref, port = both_runs["ref"][0], both_runs["port"][0]
    assert port.engine.prime_compiles == ref.engine.prime_compiles == len(BUCKETS)
    assert port.engine.decode_compiles == 1


def test_exact_token_accounting(both_runs):
    sched, done = both_runs["port"]
    assert [len(done[r].tokens) for r in sorted(done)] == [b for _, b in TRAFFIC]
    assert sched.admissions == len(TRAFFIC)
    assert sched.generated_tokens == sched.admissions + sched.decoded_tokens \
        == sum(b for _, b in TRAFFIC)
    assert (sched.admissions, sched.decoded_tokens) == (both_runs["ref"][0].admissions,
                                                        both_runs["ref"][0].decoded_tokens)


def test_continuous_matches_solo_greedy(smoke, both_runs):
    """Tokens interleaved on 2 slots (mixed buckets, mid-flight admission)
    equal each request decoded alone with exact-length prefill — slot
    isolation and pad-shadowing in one assertion."""
    _, tcfg, _, model = smoke
    done = both_runs["port"][1]
    for rid, (prompt, (_, budget)) in enumerate(zip(prompts(), TRAFFIC)):
        assert done[rid].tokens == solo_greedy(tcfg, model, prompt, budget, MAX_LEN), rid


def test_per_slot_positions_match_vmapped_reference(smoke):
    """Rows at different depths in one batched decode ≡ the reference's
    batch-of-1 decode of each row."""
    jcfg, tcfg, params, model = smoke
    eng = DecodeEngine(tcfg, slots=3, max_len=MAX_LEN, buckets=BucketSpec(BUCKETS),
                       device="cpu")
    state = eng.init_state()
    ref_caches, toks = [], []
    for slot, prompt in enumerate(prompts()[:3]):
        tok, slot_cache = eng.prime(model, prompt)
        state = eng.insert(state, slot, slot_cache, tok)
        logits, cache = jb.prefill(jcfg, NO_SHARDING, params, jnp.asarray(prompt[None]),
                                   MAX_LEN)
        assert int(tok) == int(jnp.argmax(logits[0, -1]))
        ref_caches.append(cache)
        toks.append(int(tok))
    assert state.cache["pos"].tolist() == [len(p) for p in prompts()[:3]]
    logits, cache = tb.decode_step(tcfg, model, state.cache, state.tokens)
    for slot in range(3):
        ref_logits, ref_cache = jb.decode_step(jcfg, NO_SHARDING, params, ref_caches[slot],
                                               jnp.full((1, 1), toks[slot], jnp.int32))
        np.testing.assert_allclose(logits[slot].numpy(), np.asarray(ref_logits[0]),
                                   atol=1e-5, rtol=1e-4)
        n = int(ref_cache["pos"])
        np.testing.assert_allclose(cache["k"][:, slot, :n].numpy(),
                                   np.asarray(ref_cache["k"][:, 0, :n]), atol=1e-5, rtol=1e-4)
        assert int(cache["pos"][slot]) == n


def test_slot_mask_freezes_free_slot(smoke):
    """A masked-out slot's cache (pos included) does not advance and its
    action is pinned to 0."""
    _, tcfg, _, model = smoke
    eng = DecodeEngine(tcfg, slots=2, max_len=8, buckets=BucketSpec((4,)), device="cpu")
    tok, slot_cache = eng.prime(model, np.arange(1, 4, dtype=np.int32))
    state = eng.insert(eng.init_state(), 0, slot_cache, tok)   # slot 1 stays free
    state.cache["pos"][1] = 8            # a released slot may sit at max_len
    before = {k: (v[:, 1] if k in ("k", "v") else v[1]).clone()
              for k, v in state.cache.items()}
    actions, state = eng.step(model, state)
    assert int(actions[1]) == 0
    for k, v in state.cache.items():
        after = v[:, 1] if k in ("k", "v") else v[1]
        torch.testing.assert_close(after, before[k], rtol=0, atol=0)
    assert int(state.cache["pos"][0]) == 4


# -- the server ---------------------------------------------------------------


def test_no_version_mix_within_step(smoke):
    """A publication staged while steps run lands at the NEXT boundary:
    one version per step, a clean 1 → 2 split."""
    _, tcfg, _, model = smoke
    server = ActorServer(tcfg, model, ActorServeConfig(slots=2, max_len=12, buckets=(4,),
                                                       max_new_tokens=6),
                         params_version=1, device="cpu")
    rng = np.random.RandomState(4)
    handles = [server.submit(rng.randint(0, 256, size=3)) for _ in range(2)]
    server.serve_step()
    server.serve_step()
    v2 = server.publish(model)
    assert server.params.version == 1
    assert {v for _, v, _ in server.scheduler.step_log} == {1}
    server.serve_step()
    while server.scheduler.busy:
        server.serve_step()
    assert all(h.done() for h in handles)
    log = list(server.scheduler.step_log)
    versions = [v for _, v, _ in log]
    assert versions == sorted(versions) and set(versions) == {1, v2}
    first_v2 = next(s for s, v, _ in log if v == v2)
    assert list(server._swap_log) == [(first_v2, v2)]


def test_background_server_serves_and_stops(smoke):
    _, tcfg, _, model = smoke
    server = ActorServer(tcfg, model, ActorServeConfig(slots=2, max_len=12, buckets=(4,),
                                                       max_new_tokens=4,
                                                       idle_wait_s=0.005), device="cpu")
    try:
        server.start()
        rng = np.random.RandomState(5)
        handles = [server.submit(rng.randint(0, 256, size=3)) for _ in range(5)]
        done = [h.result(timeout=120.0) for h in handles]
    finally:
        server.stop()
    assert server._thread is None
    stats = server.stats()
    assert stats["completed"] == 5 and stats["generated_tokens"] == 5 * 4
    assert all(len(c.tokens) == 4 for c in done)
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"] > 0


def test_param_source_waits_for_service_port(smoke):
    """The params channel of the ported replay service feeds the server: a
    source without ``get_params`` is refused, and a ``ReplayService``'s
    published state_dict is staged at the next step boundary, as a copy of
    the model holding those tensors."""
    import pickle

    from repro_torch.service import ReplayService, ReplayServiceConfig
    from repro_torch.service.client import as_numpy

    _, tcfg, _, model = smoke
    with pytest.raises(TypeError, match="get_params"):
        ActorServer(tcfg, model, param_source=object(), device="cpu")
    svc = ReplayService(ReplayServiceConfig(capacity_per_shard=8),
                        {"obs": np.zeros((2,), np.float32)}, device="cpu")
    server = ActorServer(tcfg, model, ActorServeConfig(slots=SLOTS, max_len=MAX_LEN,
                                                       buckets=BUCKETS, max_new_tokens=2),
                         params_version=0, param_source=svc, device="cpu")
    server.serve_step()
    assert server.stats()["param_swaps"] == 0
    scaled = {k: 2 * v for k, v in as_numpy(model).items()}
    svc.put_params(pickle.dumps(scaled))
    server.serve_step()
    stats = server.stats()
    assert stats["params_version"] == 1 and stats["param_swaps"] == 1
    live, _, _ = server.params.swap_if_staged()
    assert live is not model
    for k, t in live.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), scaled[k])


# -- the entry point ---------------------------------------------------------------


def test_serve_actor_entry_point(capsys, monkeypatch, tmp_path):
    report = tmp_path / "serve.json"
    assert serve_actor.main(["--smoke", "--device", "cpu", "--requests", "5", "--slots", "2",
                             "--prompt-len", "6", "--gen", "3",
                             "--emit-json", str(report)]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests × 3 tokens" in out and "decode:" in out
    assert '"generated_tokens": 15' in report.read_text()
    assert serve_actor.main(["--arch", "hymba_1_5b", "--device", "cpu"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_actor.main(["--smoke", "--requests", "1"])
