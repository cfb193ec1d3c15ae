"""The port's kernel wrappers (repro_torch.kernels.ops) against the JAX
Pallas kernels (repro.kernels.ops, interpret mode on the CPU), and the
rules of repro_torch.kernels.parity that hold each CUDA kernel to its
plain version.  The CUDA kernels themselves are tested on the card by
tests/test_torch_kernels_cuda.py.

On the CPU the wrappers run their plain versions (the tensors lie on the
CPU), so this file holds the plain versions to the reference.
Tolerances: sampled indices exact, or differing only under the fp-tie
rule of parity.sample_ties; priorities rtol 1e-5; gathered rows
bit-exact (compared as bytes where they hold inf or NaN); tree updates
level by level under parity.tree_mismatch (rtol 1e-5 plus 1e-6 of the
level's magnitude; the Pallas kernel sets a leaf
to old + (new − old), so leaves are held like a level, and the port's
written leaves are checked against the values exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sumtree as jst
from repro.kernels import ops as jops
from repro_torch.core import sumtree as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity

torch.set_num_threads(2)


def mk(capacity, fanout=128, seed=0, low=0.01, high=2.0):
    rng = np.random.default_rng(seed)
    pri = rng.uniform(low, high, capacity).astype(np.float32)
    js, ts = jst.make_spec(capacity, fanout), tst.make_spec(capacity, fanout)
    return (js, ts, jst.build(js, jnp.asarray(pri)),
            tst.build(ts, torch.from_numpy(pri)), rng)


def assert_update_matches(ts, got, want, idx, val):
    """The port's tree against the Pallas one level by level, and every
    surviving write of the port stored exactly."""
    assert parity.tree_mismatch(ts, got, torch.tensor(want), exact_leaves=False) == []
    last = {int(i): v for i, v in zip(idx, val)}          # last writer wins
    keys = torch.tensor(sorted(last))
    np.testing.assert_array_equal(tst.get(ts, got, keys).numpy(),
                                  np.array([last[int(k)] for k in keys], np.float32))


# -- plain versions (CPU) against the Pallas kernels --------------------------


@pytest.mark.parametrize("fanout", [8, 128, 256])
def test_sample_kernel_fanouts(fanout):
    js, ts, jt, tt, rng = mk(2000, fanout=fanout, seed=fanout)
    u = rng.uniform(0, 1, 256).astype(np.float32)
    ji, jp = jops.sumtree_sample(js, jt, jnp.asarray(u))
    ti, tp = tops.sumtree_sample(ts, tt, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)


def test_sample_kernel_padded_tail_clamp_parity():
    capacity, fanout = 10, 4
    js, ts = jst.make_spec(capacity, fanout), tst.make_spec(capacity, fanout)
    pri = np.linspace(0.5, 1.4, capacity).astype(np.float32)
    jt = jst.build(js, jnp.asarray(pri)).at[0].add(0.05).at[js.offsets[1] + 2].add(0.05)
    tt = tst.build(ts, torch.from_numpy(pri))
    tt[0] += 0.05
    tt[ts.offsets[1] + 2] += 0.05
    u = np.concatenate([np.full(4, 1.0 - 1e-7, np.float32),
                        np.linspace(0.01, 0.95, 60).astype(np.float32)])
    ji, jp = jops.sumtree_sample(js, jt, jnp.asarray(u))
    ti, tp = tops.sumtree_sample(ts, tt, torch.from_numpy(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    assert (ti.numpy()[:4] == capacity - 1).all() and (tp.numpy()[:4] > 0).all()


def _storage_pair(dtype, n, f, rng):
    if dtype == "int32":
        x = rng.integers(0, 150_000, (n, f)).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.normal(size=(n, f)).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,f,b", [(777, 5, 99), (512, 128, 128), (2048, 33, 1)])
def test_gather_kernel_matches_ref(dtype, n, f, b):
    rng = np.random.default_rng(n + f + b)
    js, ts = _storage_pair(dtype, n, f, rng)
    idx = rng.integers(0, n, b).astype(np.int32)
    want = np.asarray(jops.prioritized_gather(js, jnp.asarray(idx)).astype(jnp.float32))
    got = tops.prioritized_gather(ts, torch.from_numpy(idx).long())
    assert got.dtype == ts.dtype and got.shape == (b, f)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gather_int32_beyond_f32_exact():
    """int32 rows ≥ 2^24 (which an f32 round trip would corrupt) come
    back bit-exact, rank-1 and rank-3 alike."""
    rng = np.random.default_rng(7)
    for shape in [(300,), (300, 4, 7)]:
        x = torch.from_numpy(rng.integers(2**24, 2**31 - 1, shape).astype(np.int32))
        idx = torch.from_numpy(rng.integers(0, 300, 50))
        torch.testing.assert_close(tops.prioritized_gather(x, idx), x[idx],
                                   rtol=0, atol=0)


def test_gather_items_matches_ref():
    """Every leaf of a mixed storage dict in one call, each against the
    reference's one-leaf gather; indices past either end clamp per leaf."""
    rng = np.random.default_rng(11)
    pairs = {"f32": _storage_pair("float32", 700, 5, rng),
             "bf16": _storage_pair("bfloat16", 700, 3, rng),
             "i32": _storage_pair("int32", 650, 1, rng)}
    idx = np.concatenate([rng.integers(0, 650, 61), [-3, 649, 699, 705]]).astype(np.int32)
    got = tops.gather_items({k: t for k, (_, t) in pairs.items()},
                            torch.from_numpy(idx).long())
    assert list(got) == list(pairs)
    for k, (j, t) in pairs.items():
        want = np.asarray(jops.prioritized_gather(j, jnp.asarray(np.clip(idx, 0, j.shape[0] - 1)))
                          .astype(jnp.float32))
        assert got[k].dtype == t.dtype and got[k].shape == (65,) + tuple(t.shape[1:])
        np.testing.assert_array_equal(got[k].float().numpy(), want)


def nonfinite_storage(capacity: int, drawn: np.ndarray, rng) -> dict:
    """f32 rows with inf, -inf and NaN in rows that are not drawn and in one
    that is (``drawn[0]``), and an int32 leaf holding 2^24 + 1 and above
    (which an f32 round trip rounds)."""
    x = rng.normal(size=(capacity, 3)).astype(np.float32)
    spare = np.setdiff1d(np.arange(capacity), drawn)[:6]
    x[spare[:2], 0] = np.inf
    x[spare[2:4], 1] = np.nan
    x[spare[4:], 2] = -np.inf
    x[drawn[0]] = [np.inf, np.nan, -np.inf]
    ints = (2**24 + 1 + np.arange(capacity)).astype(np.int32)
    return {"x": torch.from_numpy(x), "n": torch.from_numpy(ints),
            "r": torch.from_numpy(rng.normal(size=capacity).astype(np.float32))}


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN != NaN, so compare the bytes)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("api", ["gather", "gather_items", "sample_gather"])
def test_nonfinite_rows_come_back_bit_for_bit(api):
    """The stored rows, inf and NaN included, bit for bit: the Pallas
    gathers' f32 one-hot matmul turns one inf into NaN in every gathered
    row of its column (ROADMAP Queue 3 item 6); the port copies bytes."""
    _, ts, _, tt, rng = mk(600, seed=31)
    u = torch.from_numpy(rng.uniform(0, 1, 40).astype(np.float32))
    idx, _ = tops.sumtree_sample(ts, tt, u)
    storage = nonfinite_storage(600, idx.numpy(), rng)
    if api == "gather":
        got = {k: tops.prioritized_gather(buf, idx) for k, buf in storage.items()}
    elif api == "gather_items":
        got = tops.gather_items(storage, idx)
    else:
        fi, _, got = tops.sumtree_sample_gather(ts, tt, u, storage)
        torch.testing.assert_close(fi, idx, rtol=0, atol=0)
    for k, buf in storage.items():
        assert same_bytes(got[k], buf[idx]), k
    assert not bool(torch.isfinite(got["x"][0]).any())
    assert int(got["n"].min()) >= 2**24 + 1


@pytest.mark.parametrize("capacity,batch", [(100, 1), (1000, 64), (16384, 300)])
def test_fused_sample_gather_matches_split_kernels(capacity, batch):
    js, ts, jt, tt, rng = mk(capacity, seed=capacity * 3 + batch)
    obs = rng.normal(size=(capacity, 5)).astype(np.float32)
    action = rng.integers(0, 7, capacity).astype(np.int32)
    reward = rng.uniform(0, 1, capacity).astype(np.float32)
    u = rng.uniform(0, 1, batch).astype(np.float32)
    ji, jp, _ = jops.sumtree_sample_gather(
        js, jt, jnp.asarray(u), {"obs": jnp.asarray(obs), "action": jnp.asarray(action),
                                 "reward": jnp.asarray(reward)})
    storage = {"obs": torch.from_numpy(obs), "action": torch.from_numpy(action),
               "reward": torch.from_numpy(reward)}
    fi, fp, items = tops.sumtree_sample_gather(ts, tt, torch.from_numpy(u), storage)
    si, sp = tops.sumtree_sample(ts, tt, torch.from_numpy(u))
    # the Pallas descent scales u by the sum of level 1, not the root: the
    # tie window widens by the difference of the two totals
    level1 = tt[ts.offsets[1]:ts.offsets[1] + ts.level_sizes[1]]
    slack = abs(float(level1.double().sum()) - float(tt[0]))
    ji_t = torch.tensor(np.asarray(ji), dtype=torch.int64)
    report = parity.sample_ties(ts, tt, torch.from_numpy(u), fi, ji_t, slack=slack)
    assert report.ok, str(report)
    agree = (fi == ji_t).numpy()
    np.testing.assert_allclose(fp.numpy()[agree], np.asarray(jp)[agree],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fi, si, rtol=0, atol=0)
    torch.testing.assert_close(fp, sp, rtol=0, atol=0)
    for k, buf in storage.items():
        torch.testing.assert_close(items[k], buf[fi], rtol=0, atol=0)
    assert items["action"].dtype == torch.int32


def test_fused_sample_gather_rank3_and_scalar_leaves():
    js, ts, jt, tt, rng = mk(500, seed=17)
    frames = rng.normal(size=(500, 3, 4)).astype(np.float32)
    done = rng.integers(0, 2, 500).astype(np.float32)
    u = rng.uniform(0, 1, 100).astype(np.float32)
    ji, _, jitems = jops.sumtree_sample_gather(
        js, jt, jnp.asarray(u), {"frames": jnp.asarray(frames), "done": jnp.asarray(done)})
    fi, _, items = tops.sumtree_sample_gather(
        ts, tt, torch.from_numpy(u),
        {"frames": torch.from_numpy(frames), "done": torch.from_numpy(done)})
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ji))
    assert items["frames"].shape == (100, 3, 4)
    np.testing.assert_array_equal(items["frames"].numpy(), np.asarray(jitems["frames"]))
    np.testing.assert_array_equal(items["done"].numpy(), np.asarray(jitems["done"]))


@pytest.mark.parametrize("capacity", [100, 4096, 100_000])
@pytest.mark.parametrize("batch", [1, 17, 257])
def test_update_kernel_matches_ref(capacity, batch):
    js, ts, jt, tt, rng = mk(capacity, seed=capacity * 7 + batch)
    idx = rng.integers(0, capacity, batch).astype(np.int32)
    val = rng.uniform(0, 5, batch).astype(np.float32)
    want = np.asarray(jops.sumtree_update(js, jt, jnp.asarray(idx), jnp.asarray(val)))
    got = tops.sumtree_update(ts, tt, torch.from_numpy(idx), torch.from_numpy(val))
    assert_update_matches(ts, got, want, idx, val)
    assert tst.check_invariant(ts, got)


def test_update_kernel_cross_block_duplicates():
    js, ts, jt, tt, rng = mk(1000, seed=9)
    b = 3 * 128
    idx = np.full(b, 42, np.int32)
    idx[::3] = rng.integers(0, 1000, len(idx[::3]))
    val = rng.uniform(0, 5, b).astype(np.float32)
    want = np.asarray(jops.sumtree_update(js, jt, jnp.asarray(idx), jnp.asarray(val)))
    got = tops.sumtree_update(ts, tt, torch.from_numpy(idx), torch.from_numpy(val))
    assert_update_matches(ts, got, want, idx, val)
    assert float(tst.get(ts, got, torch.tensor([42]))[0]) == val[np.flatnonzero(idx == 42)[-1]]


def test_update_kernel_unique_skips_dedup_correctly():
    _, ts, _, tt, rng = mk(2048, seed=23)
    idx = torch.from_numpy(rng.permutation(2048)[:256])
    val = torch.from_numpy(rng.uniform(0, 3, 256).astype(np.float32))
    t_dedup = tops.sumtree_update(ts, tt.clone(), idx, val)
    t_unique = tops.sumtree_update(ts, tt.clone(), idx, val, unique=True)
    assert parity.tree_mismatch(ts, t_unique, t_dedup) == []


def test_wrappers_refuse_other_devices():
    _, ts, _, tt, _ = mk(100, fanout=8)
    with pytest.raises(ValueError, match="no kernel"):
        tops.sumtree_sample(ts, tt.to("meta"), torch.zeros(4, device="meta"))


# -- the rules that hold a CUDA kernel to its plain version -------------------


def test_tie_rule_accepts_flips_at_a_leaf_boundary():
    """Equal leaves put a boundary at every integer: a draw placed on one
    may land on the leaf after it, not two leaves away."""
    capacity = 1000
    ts = tst.make_spec(capacity, 8)
    tt = tst.build(ts, torch.ones(capacity))
    u = torch.tensor([j / capacity for j in (17, 250, 999)], dtype=torch.float32)
    want, _ = tst.sample(ts, tt, u)
    assert parity.sample_ties(ts, tt, u, want, want).ok
    report = parity.sample_ties(ts, tt, u, want + torch.tensor([0, 1, 0]), want)
    assert report.ok and report.flips == 1, str(report)
    assert report.max_dist_ulp <= 1.0
    assert not parity.sample_ties(ts, tt, u, want + torch.tensor([0, 2, 0]), want).ok


@pytest.mark.parametrize("fanout", [8, 128])
def test_tie_rule_rejects_a_descent_one_leaf_off(fanout):
    """A descent that lands one leaf off away from the boundaries (a
    dropped carry, an off-by-one lane) fails, on a few draws as on many."""
    _, ts, _, tt, rng = mk(50_000, fanout=fanout, seed=3)
    u = torch.from_numpy(rng.uniform(0.01, 0.99, 512).astype(np.float32))
    want, _ = tst.sample(ts, tt, u)
    for every in (1, 50):
        off = want.clone()
        off[::every] += 1
        report = parity.sample_ties(ts, tt, u, off, want)
        assert not report.ok and report.max_dist_ulp > report.window_ulp, str(report)


def test_tie_rule_bounds_the_flip_count():
    """Flips within the window still fail when there are more than the
    window predicts."""
    capacity = 1000
    ts = tst.make_spec(capacity, 8)
    tt = tst.build(ts, torch.ones(capacity))
    u = (torch.arange(1, 101, dtype=torch.float32) / capacity)  # 100 boundaries
    want, _ = tst.sample(ts, tt, u)
    report = parity.sample_ties(ts, tt, u, want + 1, want)
    assert report.max_dist_ulp <= report.window_ulp
    assert report.flips > report.allowed and not report.ok


def test_tree_rule_holds_leaves_exactly_and_levels_to_their_scale():
    _, ts, _, tt, _ = mk(4096, fanout=8, seed=5)
    assert parity.tree_mismatch(ts, tt.clone(), tt) == []
    leaf = tt.clone()
    slot = ts.leaf_offset + 7
    leaf[slot] = torch.nextafter(leaf[slot], torch.tensor(10.0))   # one ulp
    assert parity.tree_mismatch(ts, leaf, tt)
    assert parity.tree_mismatch(ts, leaf, tt, exact_leaves=False) == []
    # a level-3 node off by 1e-4 of itself fails, though an atol scaled
    # to the root would let it pass
    node, slot = tt.clone(), ts.offsets[3] + 3
    node[slot] *= 1 + 1e-4
    v = float(tt[slot])
    assert 1e-4 * v < 1e-6 * float(tt[0]) + 1e-5 * v
    assert any(p.startswith("level 3") for p in parity.tree_mismatch(ts, node, tt))
