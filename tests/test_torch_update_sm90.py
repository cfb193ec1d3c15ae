"""The arithmetic of the Hopper priority update (``csrc/sumtree_update.cu``)
against the JAX package's update.

The CUDA kernel runs only on the card.  Here ``emulate`` repeats its
arithmetic in numpy f32, in the order its header comment fixes: chunks of
1,024 updates in position order; in each chunk the (index, position) keys
sorted ascending, padded to a power of two P >= 32; a sorted entry
survives when the next one holds another leaf (last writer by position)
and takes delta = new - old, every other entry 0; for each interior
level, a segmented inclusive scan of the deltas over the runs of equal
ancestors (Hillis-Steele over the 32 lanes of each warp, the warps' last
values scanned the same way, then a carry added to the lanes whose run
began in an earlier warp); the last entry of a run adds its value to the
node; the survivors' leaves are stored last.

On the CPU it is held to ``repro.kernels.ops.sumtree_update`` (the Pallas
kernel in interpret mode, as tests/test_torch_kernels.py runs it) level by
level under ``parity.tree_mismatch``'s unchanged rule, and its leaves bit
for bit to ``repro.core.sumtree.update``, the package's own update (the
Pallas kernel writes a leaf as old + (new - old), which may round).  On the
card (``cuda``) the kernel is held to ``emulate`` bit for bit, twice.  The
reference is imported inside the tests, so the card, which has no JAX,
runs the ``cuda`` case with ``--noconftest``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_update_sm90.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import sumtree as tst
from repro_torch.kernels import parity
from repro_torch.kernels.sumtree_update import CHUNK

LANES = 32
POS_BITS = CHUNK.bit_length() - 1     # kPosBits


def seg_scan(v: np.ndarray, heads: np.ndarray) -> np.ndarray:
    """``warp_seg_scan`` on (warps, 32) f32 values with run heads."""
    lane = np.arange(LANES)
    start = np.maximum.accumulate(np.where(heads, lane, -1), axis=1).clip(min=0)
    v = v.copy()
    for d in (1, 2, 4, 8, 16):
        o = np.zeros_like(v)
        o[:, d:] = v[:, :-d]
        v = np.where(lane - d >= start, o + v, v)
    return v


def emulate_chunk(spec, tree: np.ndarray, idx: np.ndarray, val: np.ndarray,
                  first_writer: bool = False) -> None:
    """One launch on ≤ 1,024 updates, in place.  ``first_writer`` is the
    mutant whose survivor is the first entry of each leaf's run."""
    n = idx.shape[0]
    p = max(LANES, 1 << (n - 1).bit_length())
    keys = np.full(p, np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = np.sort((idx.astype(np.uint64) << np.uint64(POS_BITS))
                       | np.arange(n, dtype=np.uint64))
    leaf = (keys >> np.uint64(POS_BITS)).astype(np.int64)
    pos = (keys & np.uint64(CHUNK - 1)).astype(np.int64)
    t = np.arange(p)
    valid = t < n

    def shifted(x, by):               # x[t + by], x[t] where that leaves [0, n)
        out = x.copy()
        src = t + by
        ok = valid & (src >= 0) & (src < n)
        out[ok] = x[src[ok]]
        return out

    last = t + 1 == n
    nxt, prv = shifted(leaf, 1), shifted(leaf, -1)
    if first_writer:
        survivor = valid & ((t == 0) | (prv != leaf))
    else:
        survivor = valid & (last | (nxt != leaf))
    s_at = spec.leaf_offset + leaf[survivor]
    v = val[pos[survivor]].astype(np.float32)
    delta = np.zeros(p, np.float32)
    delta[survivor] = v - tree[s_at]
    warps = p // LANES
    node = np.where(valid, leaf, 0)
    n_interior = len(spec.offsets) - 1
    for i in range(n_interior):
        node = node // spec.fanout
        level = n_interior - 1 - i
        head = ~valid | (t == 0) | (shifted(node, -1) != node)
        end = valid & (last | (shifted(node, 1) != node))
        hw = head.reshape(warps, LANES)
        s = seg_scan(delta.reshape(warps, LANES), hw)
        x = np.zeros((1, LANES), np.float32)
        x[0, :warps] = s[:, LANES - 1]
        wh = np.ones((1, LANES), bool)
        wh[0, :warps] = hw.any(axis=1)
        carry = seg_scan(x, wh)[0]
        late = (np.arange(warps) > 0)[:, None] & ~np.logical_or.accumulate(hw, axis=1)
        s = np.where(late, carry[np.maximum(np.arange(warps) - 1, 0)][:, None] + s, s)
        at = spec.offsets[level] + node[end]
        tree[at] = tree[at] + s.reshape(-1)[end]
    tree[s_at] = v


def emulate(spec, tree: np.ndarray, idx: np.ndarray, val: np.ndarray,
            first_writer: bool = False) -> np.ndarray:
    """The kernel's result on a copy of ``tree``: chunks in position order."""
    tree = tree.copy()
    for c0 in range(0, idx.shape[0], CHUNK):
        emulate_chunk(spec, tree, idx[c0:c0 + CHUNK], val[c0:c0 + CHUNK], first_writer)
    return tree


def make(capacity, fanout, batch, seed, unique=False):
    """A tree of priorities in [0.01, 2) and a batch of updates in [0, 3);
    duplicates within a chunk (every 7th entry on the first index) and
    across chunks (a later stretch repeats the first eighth)."""
    rng = np.random.default_rng(seed)
    pri = rng.uniform(0.01, 2.0, capacity).astype(np.float32)
    spec = tst.make_spec(capacity, fanout)
    tree = tst.build(spec, torch.from_numpy(pri)).numpy()
    if unique:
        idx = rng.permutation(capacity)[:batch].astype(np.int64)
    else:
        idx = rng.integers(0, capacity, batch).astype(np.int64)
        idx[1::7] = idx[0]
        idx[batch // 2:batch // 2 + batch // 8] = idx[:batch // 8]
    val = rng.uniform(0, 3, batch).astype(np.float32)
    return spec, tree, idx, val


def references(capacity, fanout, tree, idx, val, unique=False):
    """(the Pallas update in interpret mode, the package's own update)."""
    import jax.numpy as jnp

    from repro.core import sumtree as jst
    from repro.kernels import ops as jops
    js = jst.make_spec(capacity, fanout)
    args = (js, jnp.asarray(tree), jnp.asarray(idx.astype(np.int32)), jnp.asarray(val))
    return (np.array(jops.sumtree_update(*args, unique=unique)),
            np.array(jst.update(*args, unique=unique)))


def leaf_level(spec, tree):
    return tree[spec.leaf_offset:].view(np.int32)


# (capacity, K): a 6-level K=8 tree, the main path's replay, K=256, and
# K=100, where the kernel divides (a shift for a power of two)
TREES = [(5000, 8), (50_000, 128), (100_000, 256), (3000, 100)]
# one update; an odd count; past 256; past one chunk (1,024); three chunks
BATCHES = [1, 17, 257, 1025, 2100]


@pytest.mark.parametrize("capacity,fanout", TREES)
@pytest.mark.parametrize("batch", BATCHES)
def test_emulated_update_matches_reference(capacity, fanout, batch):
    spec, tree, idx, val = make(capacity, fanout, batch, seed=capacity + batch)
    got = emulate(spec, tree, idx, val)
    pallas, xla = references(capacity, fanout, tree, idx, val)
    problems = parity.tree_mismatch(spec, torch.from_numpy(got), torch.from_numpy(pallas),
                                    exact_leaves=False)
    assert problems == [], problems
    np.testing.assert_array_equal(leaf_level(spec, got), leaf_level(spec, xla))
    assert tst.check_invariant(spec, torch.from_numpy(got))


@pytest.mark.parametrize("capacity,fanout", TREES)
def test_emulated_update_unique(capacity, fanout):
    """Distinct indices (the replay's inserts), against the references'
    ``unique=True`` path, which skips its mask."""
    spec, tree, idx, val = make(capacity, fanout, 1100, seed=fanout, unique=True)
    got = emulate(spec, tree, idx, val)
    pallas, xla = references(capacity, fanout, tree, idx, val, unique=True)
    assert parity.tree_mismatch(spec, torch.from_numpy(got), torch.from_numpy(pallas),
                                exact_leaves=False) == []
    np.testing.assert_array_equal(leaf_level(spec, got), leaf_level(spec, xla))


def test_first_writer_fails_the_leaves():
    """The emulation with the first writer of each leaf surviving: the
    leaves differ from the reference's wherever a leaf was written twice."""
    spec, tree, idx, val = make(50_000, 128, 257, seed=3)
    got = emulate(spec, tree, idx, val, first_writer=True)
    _, xla = references(50_000, 128, tree, idx, val)
    assert not np.array_equal(leaf_level(spec, got), leaf_level(spec, xla))


@pytest.mark.cuda
# on the card also Nature DQN's replay, a tiny tail, and 2^22 + 1 leaves,
# whose indices take the kernel's 64-bit sort keys, with a shift (K = 128)
# and with a division (K = 100)
@pytest.mark.parametrize("capacity,fanout", TREES + [(1_000_000, 128), (10, 4),
                                                    (2**22 + 1, 128), (2**22 + 1, 100)])
@pytest.mark.parametrize("batch", BATCHES + [64, 512, 1024])
def test_cuda_update_matches_emulation(capacity, fanout, batch):
    """The kernel bit for bit against ``emulate``, on a second call too,
    in ceil(B / 1,024) launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel against its emulation)")
    from repro_torch.kernels import ops as tops
    spec, tree, idx, val = make(capacity, fanout, batch, seed=capacity + batch)
    want = emulate(spec, tree, idx, val)
    dev = torch.device("cuda")
    ti, tv = torch.from_numpy(idx).to(dev), torch.from_numpy(val).to(dev)
    outs = []
    for _ in range(2):
        before = tops.launch_counts["sumtree_update"]
        outs.append(tops.sumtree_update(spec, torch.from_numpy(tree).to(dev), ti, tv))
        assert tops.launch_counts["sumtree_update"] == before + -(-batch // CHUNK)
    torch.cuda.synchronize()
    for got in outs:
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))
