"""The arithmetic of the Hopper descent (``csrc/descend.cuh``, which the
sample and fused sample+gather kernels share) against the reference
descent ``repro.core.sumtree.sample``.

The CUDA kernel runs only on the card (tests/test_torch_kernels_cuda.py
holds it to the plain version there).  Here ``emulate`` repeats its
arithmetic in numpy, in f32 and in the kernel's order: each lane's C =
ceil(K/32) children (1, 2, 4 or 8; 8 in chunks of 256 past K = 256)
summed one after another, a Hillis-Steele scan of the 32 lane totals, the
first lane whose last csum reaches the residual and the first child in
it; no hit → the last child with csum[K-1]; a padding node (no child row)
→ the draw clamps to capacity - 1; the leaf priority is the picked
child's value, read again only when the clamp moved the leaf.  It is held
to the reference on the same tree and the same uniforms, made with
numpy, under ``parity.sample_ties``: a draw may land elsewhere only
within 4 ulp(total) of a leaf boundary in the tree's own CDF, on no more
draws than that window predicts.  The rule is the kernel's on the card,
and the summation order is the only thing that differs from the
reference, so no case gets more room than it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sumtree as jst
from repro_torch.core import sumtree as tst
from repro_torch.kernels import parity

LANES = 32


def row_width(k: int) -> int:
    """Children a lane, as ``descend::row_width``."""
    c = -(-k // LANES)
    return 1 if c <= 1 else 2 if c <= 2 else 4 if c <= 4 else 8


def scan_rows(rows: np.ndarray, residual: np.ndarray, k: int, shift: int = 1):
    """``descend::scan_row`` on (n, K) f32 rows → (cutoff, picked, row_val).
    ``shift`` is the lane the scan's exclusive prefix comes from (1: the
    lane before; 2 is the mutant that takes it a lane early)."""
    n, c = rows.shape[0], row_width(k)
    cutoff = np.full(n, -1, np.int64)
    picked = np.zeros(n, np.float32)
    row_val = np.zeros(n, np.float32)
    carry = np.zeros(n, np.float32)
    lanes = np.arange(LANES)
    open_ = np.ones(n, bool)
    for c0 in range(0, k, LANES * c):
        width = min(LANES * c, k - c0)
        chunk = np.zeros((n, LANES * c), np.float32)
        chunk[:, :width] = rows[:, c0:c0 + width]
        v = chunk.reshape(n, LANES, c)
        local = np.empty_like(v)
        local[..., 0] = v[..., 0]
        for i in range(1, c):                       # sequential in a lane
            local[..., i] = local[..., i - 1] + v[..., i]
        s = local[..., c - 1].copy()
        for d in (1, 2, 4, 8, 16):                  # Hillis-Steele over lanes
            prev = s.copy()
            s[:, d:] = prev[:, d:] + prev[:, :-d]
        before = np.zeros_like(s)
        before[:, shift:] = s[:, :-shift]
        base = carry[:, None] + before
        csum = base[..., None] + local              # (n, 32, C)
        live = c0 + lanes * c < k
        hit = live & (csum[..., c - 1] >= residual[:, None])
        any_hit = hit.any(axis=1) & open_
        src = np.argmax(hit, axis=1)
        first = np.argmax(csum[np.arange(n), src] >= residual[:, None], axis=1)
        r = np.flatnonzero(any_hit)
        cutoff[r] = c0 + src[r] * c + first[r]
        picked[r] = csum[r, src[r], first[r]]
        row_val[r] = v[r, src[r], first[r]]
        open_ &= ~any_hit
        if c0 + LANES * c >= k:                     # no hit: the last child
            r = np.flatnonzero(open_)
            lane, i = divmod(k - 1 - c0, c)
            cutoff[r] = k - 1
            picked[r] = csum[r, lane, c - 1]
            row_val[r] = v[r, lane, i]
        carry = carry + s[:, LANES - 1]
    return cutoff, picked, row_val


def emulate(spec, tree: np.ndarray, u: np.ndarray, shift: int = 1):
    """``descend::descend_warp`` for every draw → (leaf int64, priority f32)."""
    k, cap = spec.fanout, spec.capacity
    lo, hi = np.float32(1e-12), np.float32(1.0 - 1e-7)
    residual = np.minimum(np.maximum(u.astype(np.float32), lo), hi) * tree[0]
    group = np.zeros(u.shape, np.int64)
    row_val = np.zeros(u.shape, np.float32)
    live = np.ones(u.shape, bool)
    for level in range(1, spec.leaf_level + 1):
        pad = live & (group * k >= spec.level_sizes[level])
        group[pad] = cap                            # a padding node: clamp
        live &= ~pad
        a = np.flatnonzero(live)
        rows = tree[spec.offsets[level] + group[a, None] * k + np.arange(k)]
        cut, picked, rv = scan_rows(rows, residual[a], k, shift)
        residual[a] = residual[a] - (picked - rv)
        row_val[a] = rv
        group[a] = group[a] * k + cut
    leaf = np.minimum(group, cap - 1)
    pri = np.where(leaf == group, row_val, tree[spec.leaf_offset + leaf])
    return leaf, pri


def make(capacity, fanout, seed, bump=None):
    """The reference's tree (numpy f32) of uniform priorities in [0.01, 2),
    optionally bumped: ``"root"`` raises the root alone by 5 %, so the
    first level has no hit for u → 1 and the draw falls into a padding
    node; ``"interior"`` raises the root and the last real level-1 parent
    alike, so the interior exceeds its leaves and tail no-hits cascade
    down to the padded leaves."""
    rng = np.random.default_rng(seed)
    pri = rng.uniform(0.01, 2.0, capacity).astype(np.float32)
    js = jst.make_spec(capacity, fanout)
    tree = np.array(jst.build(js, jnp.asarray(pri)))
    extra = np.float32(0.05) * tree[0]
    if bump in ("root", "interior"):
        tree[0] += extra
    if bump == "interior":
        tree[js.offsets[1] + (capacity - 1) // fanout ** (js.height - 1)] += extra
    return js, tst.make_spec(capacity, fanout), tree, rng


def hold(js, ts, tree, u, shift=1):
    """The emulated descent and the reference's on one tree → the rule's
    report, after checking that every priority is the leaf's own."""
    leaf, pri = emulate(ts, tree, u, shift)
    ji, _ = jst.sample(js, jnp.asarray(tree), jnp.asarray(u))
    assert (leaf >= 0).all() and (leaf <= ts.capacity - 1).all()
    # the priority of every draw, agreeing or not, is its leaf's, bit for bit
    np.testing.assert_array_equal(pri.view(np.int32),
                                  tree[ts.leaf_offset + leaf].view(np.int32))
    t = torch.from_numpy(tree)
    return parity.sample_ties(ts, t, torch.from_numpy(u), torch.from_numpy(leaf),
                              torch.from_numpy(np.asarray(ji).astype(np.int64))), leaf


# (capacity, fanout, bump, tail draws, why the rule alone holds it)
CASES = [
    # C = 4 with one float4 a lane; 3 levels; the main path's replay size
    (50_000, 128, None, 0, "sum order only: ties within 4 ulp(total)"),
    # C = 1: one child a lane, the whole order in the warp scan
    (20_000, 8, None, 0, "sum order only; 5 levels of rounding, the same window"),
    # C = 8 with two float4s a lane
    (20_000, 256, None, 0, "sum order only: 8 sequential adds a lane"),
    # K > 256: chunks of 256 with the carry, scalar loads (1000 % 256 != 0)
    (20_000, 1000, None, 0, "sum order only; the carry adds one rounding a chunk"),
    # the interior exceeds its leaves: tail no-hits cascade into padding
    (50_000, 128, "interior", 64, "both clamp the cascade to capacity - 1"),
    # u = 1 - 1e-7 on a bumped root: level 1 has no hit, a padding node
    (20_000, 128, "root", 64, "both clamp to capacity - 1 and re-read its priority"),
]


@pytest.mark.parametrize("capacity,fanout,bump,tail,why", CASES)
def test_emulated_descent_matches_reference(capacity, fanout, bump, tail, why):
    js, ts, tree, rng = make(capacity, fanout, seed=capacity + fanout, bump=bump)
    u = np.concatenate([np.full(tail, 1.0 - 1e-7, np.float32),
                        rng.uniform(0, 1, 4096 - tail).astype(np.float32)])
    report, leaf = hold(js, ts, tree, u)
    assert report.ok, f"{why}: {report}"
    if tail:
        assert (leaf[:tail] == capacity - 1).all()


def test_rule_rejects_a_lane_scan_shifted_by_one_lane():
    """The emulation with the exclusive prefix taken from two lanes back
    (one lane's total dropped) lands whole leaves off: the rule fails it."""
    js, ts, tree, rng = make(50_000, 128, seed=5)
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    report, _ = hold(js, ts, tree, u, shift=2)
    assert not report.ok and report.max_dist_ulp > report.window_ulp, str(report)
