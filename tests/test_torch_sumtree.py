"""The port's sum tree (repro_torch.core.sumtree) against the JAX
reference (repro.core.sumtree) on the same inputs, made with numpy.

Tolerances: specs, masks and sampled indices must match exactly; f32
tree values at rtol 1e-6 (the two frameworks sum K-wide groups in their
own order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sumtree as jst
from repro_torch.core import sumtree as tst

torch.set_num_threads(2)

SPECS = [(1, 2), (5, 4), (100, 8), (1000, 128), (4096, 128), (4097, 64),
         (65536, 256), (999, 2)]


def tree_pair(capacity, fanout, seed=0, low=0.01, high=2.0):
    rng = np.random.default_rng(seed)
    pri = rng.uniform(low, high, capacity).astype(np.float32)
    js, ts = jst.make_spec(capacity, fanout), tst.make_spec(capacity, fanout)
    return js, ts, jst.build(js, jnp.asarray(pri)), tst.build(ts, torch.from_numpy(pri)), rng


def close(jtree, ttree, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(jtree), ttree.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("capacity,fanout", SPECS)
def test_make_spec_fields_match(capacity, fanout):
    js, ts = jst.make_spec(capacity, fanout), tst.make_spec(capacity, fanout)
    for field in ("capacity", "fanout", "level_sizes", "offsets", "total_size",
                  "height", "leaf_level", "leaf_offset", "num_leaves",
                  "scratch_slot"):
        assert getattr(js, field) == getattr(ts, field), field


def test_make_spec_rejects_bad_args():
    with pytest.raises(ValueError):
        tst.make_spec(0, 8)
    with pytest.raises(ValueError):
        tst.make_spec(8, 1)


@pytest.mark.parametrize("b,high,num_slots", [
    (1, 4, 16), (64, 8, 16), (300, 50, 64), (300, 50, None),
    (257, 2**20, 2**20)])   # the last one overflows the packed key → stable sort
def test_last_writer_mask_exact(b, high, num_slots):
    idx = np.random.default_rng(b + high).integers(0, high, b).astype(np.int32)
    want = np.asarray(jst.last_writer_mask(jnp.asarray(idx), num_slots))
    got = tst.last_writer_mask(torch.from_numpy(idx), num_slots).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity,fanout", SPECS)
def test_build_matches(capacity, fanout):
    js, ts, jt, tt, _ = tree_pair(capacity, fanout, seed=capacity)
    close(jt, tt)
    assert tst.check_invariant(ts, tt)
    np.testing.assert_allclose(tst.leaves(ts, tt).numpy(),
                               np.asarray(jst.leaves(js, jt)), rtol=0)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("capacity,fanout,b", [(100, 8, 37), (4097, 64, 256),
                                               (999, 2, 64)])
def test_update_and_write_leaves_match(capacity, fanout, b, unique):
    js, ts, jt, tt, rng = tree_pair(capacity, fanout, seed=b)
    if unique:
        idx = rng.permutation(capacity)[:b].astype(np.int32)
    else:
        idx = rng.integers(0, capacity, b).astype(np.int32)
    val = rng.uniform(0, 5, b).astype(np.float32)
    ji, jv = jnp.asarray(idx), jnp.asarray(val)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    close(jst.update(js, jt, ji, jv, unique=unique),
          tst.update(ts, tt.clone(), ti, tv, unique=unique), rtol=1e-6, atol=1e-5)
    # leaf-only writes are plain SETs: the leaf level matches exactly
    jw = np.asarray(jst.write_leaves(js, jt, ji, jv, unique=unique))
    tw = tst.write_leaves(ts, tt.clone(), ti, tv, unique=unique).numpy()
    np.testing.assert_array_equal(tw[ts.leaf_offset:], jw[js.leaf_offset:])
    close(jw, torch.from_numpy(tw))
    # and a rebuild after them lands where the reference lands
    close(jst.rebuild(js, jst.write_leaves(js, jt, ji, jv, unique=unique)),
          tst.rebuild(ts, tst.write_leaves(ts, tt.clone(), ti, tv, unique=unique)))


def test_update_is_in_place_and_keeps_scratch_zero():
    _, ts, _, tt, _ = tree_pair(64, 4, seed=3)
    out = tst.update(ts, tt, torch.tensor([5, 5, 9]), torch.tensor([1.0, 2.0, 3.0]))
    assert out is tt
    assert float(tt[ts.scratch_slot]) == 0.0
    assert float(tst.get(ts, tt, torch.tensor([5]))[0]) == 2.0   # last writer
    assert tst.check_invariant(ts, tt)


def test_add_matches_with_duplicates():
    js, ts, jt, tt, rng = tree_pair(777, 16, seed=5)
    idx = rng.integers(0, 777, 200).astype(np.int32)
    idx[:20] = 3
    d = rng.uniform(0, 1, 200).astype(np.float32)
    close(jst.add(js, jt, jnp.asarray(idx), jnp.asarray(d)),
          tst.add(ts, tt, torch.from_numpy(idx), torch.from_numpy(d)),
          rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("capacity,fanout", SPECS)
def test_sample_matches(capacity, fanout):
    js, ts, jt, tt, rng = tree_pair(capacity, fanout, seed=capacity + fanout)
    u = rng.uniform(0, 1, 256).astype(np.float32)
    ji, jp = jst.sample(js, jt, jnp.asarray(u))
    ti, tp = tst.sample(ts, tt, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_sample_padded_tail_clamp_matches():
    """A tree whose root exceeds its leaf sums: draws at u → 1 overshoot
    every leaf row and clamp into the padding; both sides must land on
    ``capacity - 1`` with its re-read priority."""
    capacity, fanout = 10, 4
    js, ts = jst.make_spec(capacity, fanout), tst.make_spec(capacity, fanout)
    pri = np.linspace(0.5, 1.4, capacity).astype(np.float32)
    jt = jst.build(js, jnp.asarray(pri))
    jt = jt.at[0].add(0.05).at[js.offsets[1] + 2].add(0.05)
    tt = tst.build(ts, torch.from_numpy(pri))
    tt[0] += 0.05
    tt[ts.offsets[1] + 2] += 0.05
    close(jt, tt, rtol=0, atol=0)
    u = np.concatenate([np.full(4, 1.0 - 1e-7, np.float32),
                        np.linspace(0.01, 0.95, 60).astype(np.float32)])
    ji, jp = jst.sample(js, jt, jnp.asarray(u))
    ti, tp = tst.sample(ts, tt, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    assert (ti.numpy()[:4] == capacity - 1).all() and (tp.numpy()[:4] > 0).all()


@pytest.mark.parametrize("capacity,fanout", [(50_000, 128), (999, 2), (4097, 8)])
def test_sample_tail_cascade_through_padding_nodes(capacity, fanout):
    """On a deeper tree the tail no-hits cascade into an interior padding
    node, whose child row does not exist.  The reference's dynamic_slice
    clamps that read; the port clamps the row into its level.  Both land
    on ``capacity - 1`` with its true priority."""
    js, ts, jt, tt, rng = tree_pair(capacity, fanout, seed=11)
    bump = 0.05 * float(tt[0])
    node = ts.offsets[1] + (capacity - 1) // fanout ** (ts.height - 1)
    jt = jt.at[0].add(bump).at[node].add(bump)
    tt[0] += bump
    tt[node] += bump
    u = np.concatenate([np.full(4, 1.0 - 1e-7, np.float32),
                        rng.uniform(0, 1, 60).astype(np.float32)])
    ji, jp = jst.sample(js, jt, jnp.asarray(u))
    ti, tp = tst.sample(ts, tt, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    assert (ti.numpy()[:4] == capacity - 1).all()


def test_check_invariant_detects_drift():
    _, ts, _, tt, _ = tree_pair(100, 8, seed=1)
    assert tst.check_invariant(ts, tt)
    tt[ts.offsets[1]] += 1.0
    assert not tst.check_invariant(ts, tt)
