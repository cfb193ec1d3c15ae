"""The port's prioritized replay (repro_torch.core.replay) against the JAX
reference on the same data and the same uniform draws, plus the
reference's own self-equivalences inside the port (lazy ≡ eager at flush
points bit for bit, fused ≡ split).

Tolerances: indices and leaf writes exact; importance weights and tree
values rtol 1e-5 (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.replay import PrioritizedReplay as JReplay
from repro.core.replay import ReplayConfig as JConfig
from repro_torch.core import sumtree as tst
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig

torch.set_num_threads(2)

BACKENDS = ("torch", "cuda")   # "cuda" runs the kernels' plain versions on CPU


def example(jnp_mode=False):
    lib = jnp if jnp_mode else torch
    return {"obs": lib.zeros((4,), dtype=lib.float32),
            "action": lib.zeros((), dtype=lib.int32),
            "reward": lib.zeros((), dtype=lib.float32)}


def make(capacity=256, backend="torch", fanout=8, **kw):
    return PrioritizedReplay(ReplayConfig(capacity=capacity, fanout=fanout,
                                          backend=backend, **kw),
                             example(), device="cpu")


def items_np(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.uniform(0, 1, n).astype(np.float32)}


def items(n, seed=0):
    return {k: torch.from_numpy(v) for k, v in items_np(n, seed).items()}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fused", [False, True])
def test_insert_sample_update_matches_reference(backend, fused):
    jrb = JReplay(JConfig(capacity=256, fanout=8, fused_sample_gather=fused),
                  example(jnp_mode=True))
    rb = make(256, backend, fused_sample_gather=fused)
    data = items_np(200, seed=4)
    jst_ = jrb.insert(jrb.init(), {k: jnp.asarray(v) for k, v in data.items()})
    st = rb.insert(rb.init(), items(200, seed=4))
    np.testing.assert_allclose(st.tree.numpy(), np.asarray(jst_.tree), rtol=1e-6)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jidx, jitems, jw = jrb.sample(jst_, key, 64, beta=0.6)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
        idx, got, w = rb.sample(st, None, 64, beta=0.6, u=u)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
        for k in data:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jitems[k]))
        td = np.linspace(0.1, 3.0, 64).astype(np.float32)
        jst_ = jrb.update_priorities(jst_, jidx, jnp.asarray(td))
        st = rb.update_priorities(st, idx, torch.from_numpy(td))
        np.testing.assert_allclose(st.tree.numpy(), np.asarray(jst_.tree),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(st.max_priority), float(jst_.max_priority),
                                   rtol=1e-6)


def test_zero_priority_draw_gets_zero_weight():
    """A tail draw on a zero-priority leaf weighs 0, not inf."""
    rb = make(capacity=16, fanout=4)
    st = rb.insert(rb.init(), items(10))
    st.tree[0] += 0.5                      # root above its children: u→1 overshoots
    st.tree[rb.spec.offsets[1] + 3] += 0.5
    u = torch.tensor([1.0 - 1e-7, 0.5])
    idx, _, w = rb.sample(st, None, 2, u=u)
    pri = rb.get_priority(st, idx)
    assert float(pri[0]) == 0.0 and float(w[0]) == 0.0
    assert torch.isfinite(w).all() and float(w[1]) == 1.0


def test_update_priorities_skips_dead_slots():
    rb = make(capacity=64)
    st = rb.insert(rb.init(), items(32))
    dead = torch.tensor([40, 41])          # never filled
    st = rb.update_priorities(st, torch.cat([dead, torch.tensor([3])]),
                              torch.tensor([5.0, 5.0, 5.0]))
    assert (rb.get_priority(st, dead) == 0).all()
    assert float(rb.get_priority(st, torch.tensor([3]))[0]) > 0


def test_insert_batch_larger_than_capacity_rejected():
    rb = make(capacity=16)
    st = rb.init()
    with pytest.raises(ValueError, match="capacity"):
        rb.insert_begin(st, 17)
    with pytest.raises(ValueError, match="capacity"):
        rb.insert(st, items(32))
    st = rb.insert(st, items(16))
    assert st.count == 16
    assert len(torch.unique(rb.insert_slots(st, 16))) == 16


def test_fifo_eviction_and_max_priority():
    rb = make(capacity=32)
    st = rb.insert(rb.init(), items(32, seed=0))
    first = st.storage["reward"].clone()
    st = rb.update_priorities(st, torch.arange(8), torch.full((8,), 5.0))
    st = rb.insert(st, items(8, seed=1))
    assert (st.count, st.head) == (32, 8)
    assert not torch.allclose(st.storage["reward"][:8], first[:8])
    torch.testing.assert_close(st.storage["reward"][8:], first[8:])
    assert (rb.get_priority(st, torch.arange(8)) == st.max_priority).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_lazy_flush_bitexact_vs_eager_per_op_flush(backend):
    rb = make(capacity=64, backend=backend)
    st_lazy = rb.insert(rb.init(), items(64))
    st_eager = st_lazy.clone()             # the ops update tensors in place

    st_lazy, slots = rb.insert_begin(st_lazy, 16, lazy=True)
    st_eager, slots_e = rb.insert_begin(st_eager, 16, lazy=True)
    st_eager = rb.flush(st_eager)
    torch.testing.assert_close(slots, slots_e, rtol=0, atol=0)

    idx = torch.tensor([3, 40, 3, 3, 25, 40, 63, 3])
    td = torch.linspace(0.1, 3.0, 8)
    st_lazy = rb.update_priorities(st_lazy, idx, td, lazy=True)
    st_eager = rb.flush(rb.update_priorities(st_eager, idx, td, lazy=True))

    st_lazy = rb.insert_commit(st_lazy, slots, items(16, seed=1), lazy=True)
    st_eager = rb.flush(rb.insert_commit(st_eager, slots_e, items(16, seed=1),
                                         lazy=True))
    st_lazy = rb.flush(st_lazy)            # ONE merged propagation pass
    torch.testing.assert_close(st_lazy.tree, st_eager.tree, rtol=0, atol=0)
    assert st_lazy.pending == 0
    assert tst.check_invariant(rb.spec, st_lazy.tree)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lazy_matches_eager_update_allclose(backend):
    rb = make(capacity=128, backend=backend)
    st0 = rb.insert(rb.init(), items(128))

    def run(lazy):
        st, slots = rb.insert_begin(st0.clone(), 32, lazy=lazy)
        st = rb.flush(st)
        st = rb.update_priorities(st, torch.tensor([5, 5, 77, 100, 5, 77]),
                                  torch.linspace(0.2, 2.0, 6), lazy=lazy)
        st = rb.insert_commit(st, slots, items(32, seed=2), lazy=lazy)
        return rb.flush(st)

    torch.testing.assert_close(run(True).tree, run(False).tree, rtol=1e-5, atol=1e-4)


def test_pending_ledger_counts_and_flush_resets():
    rb = make(capacity=64)
    st = rb.insert(rb.init(), items(64))
    assert st.pending == 0
    st, slots = rb.insert_begin(st, 8, lazy=True)
    st = rb.update_priorities(st, torch.arange(4), torch.ones(4), lazy=True)
    st = rb.insert_commit(st, slots, items(8, seed=3), lazy=True)
    assert st.pending == 20
    st = rb.flush(st)
    assert st.pending == 0 and tst.check_invariant(rb.spec, st.tree)
    before = rb.ops.counts["flush"]
    tree = st.tree.clone()
    st = rb.flush(st)                      # clean state: an exact no-op
    assert rb.ops.counts["flush"] == before
    torch.testing.assert_close(st.tree, tree, rtol=0, atol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_sample_gather_matches_split(backend):
    rb_f = make(256, backend, fused_sample_gather=True)
    rb_s = make(256, backend, fused_sample_gather=False)
    st_f = rb_f.insert(rb_f.init(), items(200, seed=4))
    st_s = rb_s.insert(rb_s.init(), items(200, seed=4))
    for seed in range(3):
        i_f, it_f, w_f = rb_f.sample(st_f, torch.Generator().manual_seed(seed), 64)
        i_s, it_s, w_s = rb_s.sample(st_s, torch.Generator().manual_seed(seed), 64)
        torch.testing.assert_close(i_f, i_s, rtol=0, atol=0)
        torch.testing.assert_close(w_f, w_s, rtol=0, atol=0)
        for k in it_f:
            torch.testing.assert_close(it_f[k], it_s[k], rtol=0, atol=0)
    assert rb_f.ops.counts["sample_gather"] == 3 and rb_s.ops.counts["sample"] == 3


def test_append_is_one_lazy_transaction():
    """append = begin + commit with no learner between: the items become
    sampleable at the next flush, at P_max."""
    rb = make(capacity=64)
    st = rb.insert(rb.init(), items(32))
    st = rb.append(st, items(8, seed=5))
    assert st.pending == 16 and (st.head, st.count) == (40, 40)
    st = rb.flush(st)
    assert (rb.get_priority(st, torch.arange(32, 40)) == st.max_priority).all()
    torch.testing.assert_close(st.storage["obs"][32:40], items(8, seed=5)["obs"])
    assert tst.check_invariant(rb.spec, st.tree)


def test_backend_defaults_and_unknown_backend():
    rb = make(backend=None)
    assert rb.ops.name == "torch"          # the CPU default
    assert not rb.config.fused_sample_gather
    with pytest.raises(ValueError, match="unknown tree-ops backend"):
        make(backend="pallas")
