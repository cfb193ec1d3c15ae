"""Each CUDA kernel against its plain PyTorch version, on an NVIDIA GPU.

Every test here needs the card: marked ``cuda``, each skips without one.
The file imports no JAX, so it also runs on a GPU machine that has none.
tests/conftest.py imports jax, so there run it without the conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes: the main path's replay (50,000, K=128, B=64), the Nature-DQN
replay (10^6, K=128, B=512), K=8 and K=256 at 10^5, and a 10-leaf tree
whose tail draws clamp; for the descent also K=64 and K=1000 (chunks of
256), and a root raised alone at 128^3 + 1 and 64^4 + 1 leaves, where a
descent past its padding-node guard would read 1-2 GB past the tree.
The gathers: one leaf a launch and every leaf in one launch (mixed
dtypes and row sizes of 1 to 1,024 bytes, unaligned views, 16 leaves;
17 raise), rows with inf, NaN and int32 above 2^24 byte for byte, and
one replay sample on the split path = one descent and one gather
launch.  The fused kernel also on a table of 1- to 1,024-byte rows
with views 4, 2 and 1 bytes off alignment and on 16 leaves.  The update
at the shapes above, at B = 1 to 2,100 (past one launch's 1,024, with
repeats across chunks; ceil(B / 1,024) launches) also at K = 100 (a
division where K is no power of two) and at 2^22 + 1 leaves (64-bit
sort keys) with K = 128 and K = 100, and a second call bit for bit.  Tolerances are the rules of
repro_torch.kernels.parity: sampled indices under the fp-tie rule and
priorities exact where the indices agree; rows bit-exact; the update's
leaves bit for bit and each interior level at rtol 1e-5 plus 1e-6 of its
own magnitude.  Flash attention (forward): the five mask cases of
tests/test_flash_attention.py at (4, 256, 64) f32, hd 16, 96 and 128, a
ragged S = 200, and the Granite-8B prefill shapes (32, 128/512, 128) in
bf16; the Hopper forward (bf16) at every mask and hd 64/96/128, ragged S
200 and 1,000, Sk != S, (32, 4096, 128) and the training shape (128,
256, 128), with its launch count, and with NaN rows after each tensor
that it must not read; all held by
parity.flash_check (f32 O at atol 2e-6 + rtol 1e-4, bf16 O
within one bf16 ulp of the f32 plain result + 2e-6, LSE rtol 1e-5 +
atol 1e-6).  Flash attention (backward): the same cases and the
InternLM2-1.8B training shape (128, 256, 128) bf16, the backward pair that
flash_attention_bwd_cuda picks (the Hopper dQ and dK/dV kernels for bf16
at hd 64/96/128, the f32 pair otherwise) against the plain backward in
f32 on the same q, k, v, O, LSE and dO (O and LSE from the forward
kernel), held by parity.flash_bwd_check (f32 at atol 2e-5 + rtol 1e-3,
bf16 within one bf16 ulp beyond 2e-5), with its launch count; the Hopper
pair also at the Hopper forward's cases, bit for bit the same on a second
call, and with NaN rows after each tensor that it must not read;
and the autograd Function's f32 gradients against autograd through the
plain forward, at that same f32 bar.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import sumtree as tst
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity
from repro_torch.kernels import sumtree_update as kupdate

# CartPole's replay, the Nature-DQN size, the token-DQN training path's
# replay (8,192, K = 128, B = 8), K = 8 and K = 256, and a tiny tail
SHAPES = [(50_000, 128, 64), (1_000_000, 128, 512), (8192, 128, 8), (100_000, 8, 512),
          (100_000, 256, 512), (10, 4, 64)]
# the descent's other instances: K > 256 in chunks with scalar loads, and
# K = 64 (C = 2, float2 loads)
SAMPLE_SHAPES = SHAPES + [(20_000, 1000, 512), (20_000, 64, 512)]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel against its plain version)")
    tops.build_all()
    return torch.device("cuda")


def mk(capacity, fanout, seed, device):
    rng = np.random.default_rng(seed)
    pri = rng.uniform(0.01, 2.0, capacity).astype(np.float32)
    ts = tst.make_spec(capacity, fanout)
    return ts, tst.build(ts, torch.from_numpy(pri).to(device)), rng


def _bumped(ts, tt):
    """Root and the last real level-1 parent raised: u → 1 draws clamp
    into the padded tail."""
    extra = 0.05 * float(tt[0])
    tt[0] += extra
    tt[ts.offsets[1] + (ts.capacity - 1) // ts.fanout ** (ts.height - 1)] += extra
    return tt


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,fanout,batch", SAMPLE_SHAPES)
def test_cuda_sample_matches_plain(cuda_dev, capacity, fanout, batch):
    ts, tt, rng = mk(capacity, fanout, capacity + fanout, cuda_dev)
    for tree in (tt, _bumped(ts, tt.clone())):
        for draws in (batch, 65_536):
            u = torch.from_numpy(np.concatenate([
                np.full(4, 1.0 - 1e-7, np.float32),
                rng.uniform(0, 1, draws - 4).astype(np.float32)])).to(cuda_dev)
            ki, kp = tops.sumtree_sample(ts, tree, u)
            pi, pp = tst.sample(ts, tree, u)
            torch.cuda.synchronize()
            report = parity.sample_ties(ts, tree, u, ki, pi)
            assert report.ok, str(report)
            agree = ki == pi
            torch.testing.assert_close(kp[agree], pp[agree], rtol=0, atol=0)
            assert bool((ki[:4] <= capacity - 1).all()) and bool((kp[:4] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,fanout", [(128**3 + 1, 128), (64**4 + 1, 64)])
def test_cuda_sample_padding_cascade_stays_in_the_tree(cuda_dev, capacity, fanout):
    """The root alone raised by 5 %: a draw past the leaves' total has no
    hit at level 1, whose last child is a padding node with no child row.
    The descent must clamp there (capacity - 1, its priority re-read); a
    descent that went on would read rows up to ~1 GB past the tree."""
    torch.cuda.empty_cache()
    ts, tt, rng = mk(capacity, fanout, 3, cuda_dev)
    tt[0] *= 1.05
    u = torch.from_numpy(np.concatenate([
        np.full(4, 1.0 - 1e-7, np.float32),
        rng.uniform(0.9, 1.0, 4092).astype(np.float32)])).to(cuda_dev)
    ki, kp = tops.sumtree_sample(ts, tt, u)
    pi, pp = tst.sample(ts, tt, u)
    torch.cuda.synchronize()
    report = parity.sample_ties(ts, tt, u, ki, pi)
    assert report.ok, str(report)
    past = u > 1 / 1.05 + 1e-4
    assert int(past.sum()) > 100 and bool((ki[past] == capacity - 1).all())
    torch.testing.assert_close(kp[ki == pi], pp[ki == pi], rtol=0, atol=0)
    assert bool((kp[past] == tst.get(ts, tt, ki[past])).all())


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN != NaN, so compare the bytes)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def rows_of(dev, g, dtype, shape):
    if dtype == torch.int32:
        return torch.randint(0, 2**31 - 1, shape, generator=g, device=dev, dtype=torch.int32)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["prioritized_gather", "gather_items"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape", [(5000,), (5000, 4), (5000, 3, 5), (5000, 33),
                                   (8192, 256)])
def test_cuda_gather_bit_exact(cuda_dev, dtype, shape, api):
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    x = rows_of(cuda_dev, g, dtype, shape)
    idx = torch.randint(0, shape[0], (517,), generator=g, device=cuda_dev)
    before = tops.launch_counts["gather"]
    if api == "prioritized_gather":
        got = tops.prioritized_gather(x, idx)
    else:
        got = tops.gather_items({"x": x}, idx)["x"]
    torch.testing.assert_close(got, x[idx], rtol=0, atol=0)
    assert tops.launch_counts["gather"] == before + 1


def _unaligned(dev, g, n):
    """Contiguous views that start 4, 2 and 1 bytes into their buffers."""
    f = rows_of(dev, g, torch.float32, (n * 4 + 1,))[1:].view(n, 4)
    h = rows_of(dev, g, torch.bfloat16, (n * 3 + 1,))[1:].view(n, 3)
    b = rows_of(dev, g, torch.uint8, (n * 6 + 1,))[1:].view(n, 6)
    return {"f32x4+4": f, "bf16x3+2": h, "u8x6+1": b}


# leaf tables of one gather_items launch: row sizes of 1, 4, 12, 16 and
# 1,024 bytes in mixed dtypes and row counts; views that start unaligned;
# 16 leaves
TABLES = {
    "mixed": lambda dev, g, n: {
        "u8": rows_of(dev, g, torch.uint8, (n,)),
        "f32": rows_of(dev, g, torch.float32, (n - 7,)),
        "i32x3": rows_of(dev, g, torch.int32, (n + 3, 3)),
        "f32x4": rows_of(dev, g, torch.float32, (n, 4)),
        "bf16x512": rows_of(dev, g, torch.bfloat16, (n - 1, 512))},
    "unaligned": _unaligned,
    "16 leaves": lambda dev, g, n: {
        f"l{j}": rows_of(dev, g, (torch.float32, torch.int32, torch.bfloat16, torch.uint8)[j % 4],
                         (n - j,) + ((j % 5 + 1,) if j % 3 else ()))
        for j in range(16)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("table", list(TABLES))
def test_cuda_gather_items_bit_exact(cuda_dev, table):
    """Every leaf in one launch, bit for bit against the plain gather; the
    indices include -3 and past every leaf's last row, which clamp per leaf."""
    g = torch.Generator(device=cuda_dev).manual_seed(2)
    storage = TABLES[table](cuda_dev, g, 3000)
    idx = torch.cat([torch.randint(0, 2990, (300,), generator=g, device=cuda_dev),
                     torch.tensor([-3, 0, 2999, 3002, 3500], device=cuda_dev)])
    before = tops.launch_counts["gather"]
    got = tops.gather_items(storage, idx)
    torch.cuda.synchronize()
    assert tops.launch_counts["gather"] == before + 1
    assert list(got) == list(storage)
    for k, buf in storage.items():
        assert same_bytes(got[k], buf[idx.clamp(0, buf.shape[0] - 1)]), k


@pytest.mark.cuda
def test_cuda_gather_items_refuses_17_leaves(cuda_dev):
    storage = {f"l{j}": torch.zeros((10, 2), device=cuda_dev) for j in range(17)}
    idx = torch.zeros((4,), dtype=torch.int64, device=cuda_dev)
    before = tops.launch_counts["gather"]
    with pytest.raises(ValueError, match="16"):
        tops.gather_items(storage, idx)
    with pytest.raises(ValueError, match="CUDA device"):
        tops.gather_items({"x": torch.zeros((10, 2), device=cuda_dev)}, idx.cpu())
    assert tops.launch_counts["gather"] == before


def nonfinite_storage(dev, capacity, drawn):
    """f32 rows with inf, -inf and NaN in rows that are not drawn and in one
    that is (``drawn[0]``), and an int32 leaf holding 2^24 + 1 and above."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((capacity, 3), generator=g, device=dev)
    taken = torch.zeros(capacity, dtype=torch.bool, device=dev)
    taken[drawn] = True
    spare = torch.nonzero(~taken)[:6, 0]
    x[spare[:2], 0] = float("inf")
    x[spare[2:4], 1] = float("nan")
    x[spare[4:], 2] = float("-inf")
    x[drawn[0]] = torch.tensor([float("inf"), float("nan"), float("-inf")], device=dev)
    ints = (2**24 + 1 + torch.arange(capacity, device=dev)).to(torch.int32)
    return {"x": x, "n": ints, "r": torch.randn((capacity,), generator=g, device=dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["gather", "gather_items", "sample_gather"])
def test_cuda_nonfinite_rows_come_back_bit_for_bit(cuda_dev, api):
    ts, tt, rng = mk(50_000, 128, 31, cuda_dev)
    u = torch.from_numpy(rng.uniform(0, 1, 64).astype(np.float32)).to(cuda_dev)
    idx, _ = tops.sumtree_sample(ts, tt, u)
    storage = nonfinite_storage(cuda_dev, 50_000, idx)
    if api == "gather":
        got = {k: tops.prioritized_gather(buf, idx) for k, buf in storage.items()}
    elif api == "gather_items":
        got = tops.gather_items(storage, idx)
    else:
        fi, _, got = tops.sumtree_sample_gather(ts, tt, u, storage)
        torch.testing.assert_close(fi, idx, rtol=0, atol=0)
    torch.cuda.synchronize()
    for k, buf in storage.items():
        assert same_bytes(got[k], buf[idx]), k
    assert not bool(torch.isfinite(got["x"][0]).any())
    assert int(got["n"].min()) >= 2**24 + 1


@pytest.mark.cuda
def test_cuda_replay_split_sample_launches_once(cuda_dev):
    """One PrioritizedReplay.sample on the split path: one descent launch
    and one gather launch for CartPole's five leaves, the items bit for bit
    those of five one-leaf gathers."""
    example = {"obs": torch.zeros(4), "action": torch.zeros((), dtype=torch.int32),
               "reward": torch.zeros(()), "next_obs": torch.zeros(4), "done": torch.zeros(())}
    rb = PrioritizedReplay(ReplayConfig(capacity=5000, fanout=128), example, device=cuda_dev)
    g = torch.Generator(device=cuda_dev).manual_seed(4)
    items = {k: rows_of(cuda_dev, g, v.dtype, (3000,) + tuple(v.shape))
             for k, v in example.items()}
    st = rb.insert(rb.init(), items)
    before = dict(tops.launch_counts)
    idx, got, _ = rb.sample(st, g, 64)
    torch.cuda.synchronize()
    for name in ("sumtree_sample", "gather"):
        assert tops.launch_counts[name] == before.get(name, 0) + 1, name
    assert rb.ops.counts["gather"] == 5
    for k, buf in st.storage.items():
        assert same_bytes(got[k], tops.prioritized_gather(buf, idx)), k


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,fanout,batch", SHAPES)
def test_cuda_sample_gather_matches_split(cuda_dev, capacity, fanout, batch):
    ts, tt, _ = mk(capacity, fanout, capacity, cuda_dev)
    g = torch.Generator(device=cuda_dev).manual_seed(1)
    storage = {"obs": torch.randn((capacity, 4), generator=g, device=cuda_dev),
               "action": torch.randint(0, 2**31 - 1, (capacity,), generator=g,
                                       device=cuda_dev, dtype=torch.int32),
               "frames": torch.randn((capacity, 3, 5), generator=g,
                                     device=cuda_dev).to(torch.bfloat16)}
    u = torch.rand((batch,), generator=g, device=cuda_dev)
    fi, fp, items = tops.sumtree_sample_gather(ts, tt, u, storage)
    si, sp = tops.sumtree_sample(ts, tt, u)
    torch.testing.assert_close(fi, si, rtol=0, atol=0)
    torch.testing.assert_close(fp, sp, rtol=0, atol=0)
    for k, buf in storage.items():
        torch.testing.assert_close(items[k], buf[si], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("capacity,fanout,batch", SHAPES)
def test_cuda_update_matches_plain(cuda_dev, capacity, fanout, batch, unique):
    ts, tt, rng = mk(capacity, fanout, capacity + 1, cuda_dev)
    if unique:
        idx = rng.permutation(capacity)[:batch]
    else:
        idx = rng.integers(0, capacity, batch)
        idx[: batch // 4] = idx[0]           # duplicates
    idx = torch.from_numpy(idx).to(cuda_dev)
    val = torch.from_numpy(rng.uniform(0, 3, idx.shape[0]).astype(np.float32)).to(cuda_dev)
    got = tops.sumtree_update(ts, tt.clone(), idx, val, unique=unique)
    want = tst.update(ts, tt.clone(), idx, val, unique=unique)
    again = tops.sumtree_update(ts, tt.clone(), idx, val, unique=unique)
    torch.cuda.synchronize()
    assert parity.tree_mismatch(ts, got, want) == []
    assert tst.check_invariant(ts, got)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


# the eager update's batches: an insert, CartPole's, Nature DQN's, past one
# CTA of 1,024 updates, and three chunks; duplicates across the whole batch
UPDATE_BATCHES = [1, 8, 64, 512, 1025, 2100]


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,fanout", [(50_000, 128), (100_000, 8), (3000, 100),
                                             (2**22 + 1, 128), (2**22 + 1, 100)])
@pytest.mark.parametrize("batch", UPDATE_BATCHES)
def test_cuda_update_chunks_and_repeats(cuda_dev, capacity, fanout, batch):
    """ceil(B / 1,024) launches; leaves bit for bit and the interior under
    the level rule against the plain version, with every fifth entry a
    repeat of an earlier one (within and across chunks); a second call on
    the same inputs bit for bit the same."""
    ts, tt, rng = mk(capacity, fanout, capacity + batch, cuda_dev)
    idx = rng.integers(0, capacity, batch)
    idx[4::5] = idx[rng.integers(0, batch, idx[4::5].shape[0])]
    idx = torch.from_numpy(idx).to(cuda_dev)
    val = torch.from_numpy(rng.uniform(0, 3, batch).astype(np.float32)).to(cuda_dev)
    before = tops.launch_counts["sumtree_update"]
    got = tops.sumtree_update(ts, tt.clone(), idx, val)
    assert tops.launch_counts["sumtree_update"] == before + -(-batch // kupdate.CHUNK)
    again = tops.sumtree_update(ts, tt.clone(), idx, val)
    want = tst.update(ts, tt.clone(), idx, val)
    torch.cuda.synchronize()
    assert parity.tree_mismatch(ts, got, want) == []
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _mixed_misaligned(dev, g, n):
    """Rows of 1, 4, 12, 16 and 1,024 bytes, and views that start 4, 2 and 1
    bytes into their buffers (a 16-byte row 4 bytes off its alignment)."""
    return {**TABLES["mixed"](dev, g, n), **_unaligned(dev, g, n)}


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["mixed+misaligned", "16 leaves"])
def test_cuda_sample_gather_leaf_tables(cuda_dev, table):
    """The fused kernel on leaf tables of every vector width, one launch:
    indices and priorities those of the split descent on the same u, rows
    byte for byte (each leaf's row index clamped into its own rows)."""
    ts, tt, _ = mk(3000, 128, 11, cuda_dev)
    g = torch.Generator(device=cuda_dev).manual_seed(5)
    storage = (_mixed_misaligned if table == "mixed+misaligned" else TABLES[table])(
        cuda_dev, g, 3000)
    u = torch.cat([torch.full((4,), 1.0 - 1e-7, device=cuda_dev),
                   torch.rand((508,), generator=g, device=cuda_dev)])
    before = tops.launch_counts["sample_gather"]
    fi, fp, items = tops.sumtree_sample_gather(ts, tt, u, storage)
    si, sp = tops.sumtree_sample(ts, tt, u)
    torch.cuda.synchronize()
    assert tops.launch_counts["sample_gather"] == before + 1
    assert torch.equal(fi, si) and torch.equal(fp, sp)
    for k, buf in storage.items():
        assert same_bytes(items[k], buf[si.clamp(0, buf.shape[0] - 1)]), k


FLASH_CASES = [
    (4, 256, 64, "full", 0, True, True, torch.float32),
    (4, 256, 64, "full", 0, False, True, torch.float32),
    (4, 256, 64, "sliding", 64, True, False, torch.float32),
    (4, 256, 64, "sliding", 64, True, True, torch.float32),
    (4, 256, 64, "chunked", 64, True, False, torch.float32),
    (8, 128, 16, "full", 0, True, True, torch.float32),
    (3, 200, 128, "full", 0, True, True, torch.float32),
    (3, 200, 96, "sliding", 50, True, False, torch.float32),
    (2, 200, 64, "chunked", 48, False, False, torch.float32),
    (32, 128, 128, "full", 0, True, True, torch.bfloat16),
    (32, 512, 128, "full", 0, True, True, torch.bfloat16),
    (4, 200, 64, "sliding", 64, True, False, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,hd,attn,win,causal,glob,dtype", FLASH_CASES)
def test_cuda_flash_matches_plain(cuda_dev, n, s, hd, attn, win, causal, glob, dtype):
    g = torch.Generator(device=cuda_dev).manual_seed(n * s + hd)
    q, k, v = ((torch.randn((n, s, hd), generator=g, device=cuda_dev) * 0.3).to(dtype)
               for _ in range(3))
    o, lse = tfa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
    o_ref, lse_ref = tfa.flash_attention_plain(q.float(), k.float(), v.float(), attn, win,
                                               causal, glob)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    report = parity.flash_check(o, lse, o_ref, lse_ref)
    assert report.ok, report


# the Hopper forward (bf16 at hd 64/96/128): (n, s, sk, hd, attention, window,
# causal, is_global) — every mask at each hd, ragged S, Sk != S, and the
# serve and train shapes
MASKS = [("full", 0, True, True), ("full", 0, False, True), ("sliding", 64, True, False),
         ("sliding", 64, True, True), ("chunked", 64, True, False)]
SM90_CASES = [(4, 256, 256, hd, *m) for hd in (64, 96, 128) for m in MASKS] + [
    (3, 200, 200, 128, "full", 0, True, True), (2, 1000, 1000, 128, "full", 0, True, True),
    (3, 200, 200, 96, "sliding", 50, True, False), (2, 1000, 1000, 64, "chunked", 96, True, False),
    (2, 256, 100, 128, "full", 0, False, True), (2, 100, 300, 128, "full", 0, True, True),
    (2, 300, 1000, 64, "full", 0, False, True), (32, 4096, 4096, 128, "full", 0, True, True),
    (128, 256, 256, 128, "full", 0, True, True)]


def _sm90_check(dev, n, s, sk, hd, attn, win, causal, glob):
    g = torch.Generator(device=dev).manual_seed(n * s + sk + hd)
    q = (torch.randn((n, s, hd), generator=g, device=dev) * 0.3).bfloat16()
    k, v = ((torch.randn((n, sk, hd), generator=g, device=dev) * 0.3).bfloat16()
            for _ in range(2))
    before = dict(tops.launch_counts)
    o, lse = tfa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
    o_ref, lse_ref = tfa.flash_attention_plain(q.float(), k.float(), v.float(), attn, win,
                                               causal, glob)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tops.launch_counts[tfa.SM90_NAME] == before.get(tfa.SM90_NAME, 0) + 1
    assert tops.launch_counts[tfa.NAME] == before.get(tfa.NAME, 0)
    report = parity.flash_check(o, lse, o_ref, lse_ref)
    assert report.ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,sk,hd,attn,win,causal,glob", SM90_CASES)
def test_cuda_flash_sm90_matches_plain(cuda_dev, n, s, sk, hd, attn, win, causal, glob):
    """The Hopper forward, routed by flash_attention_cuda, against the plain
    version in f32; one launch of it and none of the f32 kernel."""
    _sm90_check(cuda_dev, n, s, sk, hd, attn, win, causal, glob)


@pytest.mark.cuda
@pytest.mark.parametrize("s,sk,hd", [(200, 200, 128), (256, 100, 64), (130, 1000, 96)])
def test_cuda_flash_sm90_reads_nothing_past_its_tensors(cuda_dev, s, sk, hd):
    """q, k and v each followed in memory by NaN rows: the tensor maps are
    3-D, so the tiles that run past S or Sk are zero-filled and never read
    those rows (a map over all heads' rows at once would read them into the
    last head's P·V, 0·NaN = NaN)."""
    n = 3
    g = torch.Generator(device=cuda_dev).manual_seed(s + sk + hd)

    def guarded(rows):
        buf = torch.full((n * rows + 128, hd), float("nan"), dtype=torch.bfloat16,
                         device=cuda_dev)
        x = buf[: n * rows].view(n, rows, hd)
        x.copy_(torch.randn((n, rows, hd), generator=g, device=cuda_dev) * 0.3)
        return x

    q, k, v = guarded(s), guarded(sk), guarded(sk)
    o, lse = tfa.flash_attention_cuda(q, k, v)
    o_ref, lse_ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    report = parity.flash_check(o, lse, o_ref, lse_ref)
    assert report.ok, report


FLASH_BWD_CASES = FLASH_CASES + [(128, 256, 128, "full", 0, True, True, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,hd,attn,win,causal,glob,dtype", FLASH_BWD_CASES)
def test_cuda_flash_bwd_matches_plain(cuda_dev, n, s, hd, attn, win, causal, glob, dtype):
    g = torch.Generator(device=cuda_dev).manual_seed(n * s + hd + 1)
    q, k, v, do = ((torch.randn((n, s, hd), generator=g, device=cuda_dev) * 0.3).to(dtype)
                   for _ in range(4))
    o, lse = tfa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
    before = dict(tops.launch_counts)
    dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, attn, win, causal, glob)
    ref = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                        do.float(), attn, win, causal, glob)
    torch.cuda.synchronize()
    assert all(t.dtype == dtype for t in (dq, dk, dv))
    _assert_bwd_launches(before, tfa._bwd_kernel_for(dtype, hd))
    report = parity.flash_bwd_check(dq, dk, dv, *ref)
    assert report.ok, report


def _assert_bwd_launches(before, chosen):
    """One launch of each kernel of the chosen backward pair, none of the other pair."""
    for name in (tfa.DQ_NAME, tfa.DKV_NAME, tfa.DQ_SM90_NAME, tfa.DKV_SM90_NAME):
        assert tops.launch_counts[name] == before.get(name, 0) + (name in chosen), name


def _bwd_inputs(dev, n, s, sk, hd, attn, win, causal, glob, rows=None):
    """bf16 q, dO (n, s, hd) and k, v (n, sk, hd) ~N(0, 0.3²), with the
    Hopper forward's O and LSE; ``rows(n, r)`` makes each tensor's storage."""
    g = torch.Generator(device=dev).manual_seed(n * s + sk + hd + 2)
    rows = rows or (lambda n_, r: torch.empty((n_, r, hd), dtype=torch.bfloat16, device=dev))

    def rnd(r):
        x = rows(n, r)
        x.copy_(torch.randn((n, r, hd), generator=g, device=dev) * 0.3)
        return x

    q, k, v, do = rnd(s), rnd(sk), rnd(sk), rnd(s)
    o, lse = tfa.flash_attention_cuda(q, k, v, attn, win, causal, glob)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,sk,hd,attn,win,causal,glob", SM90_CASES)
def test_cuda_flash_bwd_sm90_matches_plain(cuda_dev, n, s, sk, hd, attn, win, causal, glob):
    """The Hopper backward pair, routed by flash_attention_bwd_cuda, against
    the plain backward in f32 on the forward kernel's O and LSE; one launch
    of each and none of the f32 pair; a second call bit for bit the same."""
    q, k, v, o, lse, do = _bwd_inputs(cuda_dev, n, s, sk, hd, attn, win, causal, glob)
    before = dict(tops.launch_counts)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, attn, win, causal, glob)
    _assert_bwd_launches(before, (tfa.DQ_SM90_NAME, tfa.DKV_SM90_NAME))
    again = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, attn, win, causal, glob)
    ref = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                        do.float(), attn, win, causal, glob)
    torch.cuda.synchronize()
    assert all(t.dtype == torch.bfloat16 for t in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    report = parity.flash_bwd_check(*got, *ref)
    assert report.ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("s,sk,hd", [(200, 200, 128), (256, 100, 64), (130, 1000, 96)])
def test_cuda_flash_bwd_sm90_reads_nothing_past_its_tensors(cuda_dev, s, sk, hd):
    """q, k, v and dO each followed in memory by NaN rows: the 3-D tensor maps
    zero-fill the tiles that run past S or Sk and never read those rows."""
    def guarded(n, r):
        buf = torch.full((n * r + 128, hd), float("nan"), dtype=torch.bfloat16, device=cuda_dev)
        return buf[: n * r].view(n, r, hd)

    q, k, v, o, lse, do = _bwd_inputs(cuda_dev, 3, s, sk, hd, "full", 0, True, True, guarded)
    got = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    ref = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                        do.float())
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    report = parity.flash_bwd_check(*got, *ref)
    assert report.ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("attn,win,causal,glob", [("full", 0, True, True),
                                                  ("sliding", 64, True, False),
                                                  ("chunked", 48, False, False)])
def test_cuda_flash_function_grads_match_autograd(cuda_dev, attn, win, causal, glob):
    g = torch.Generator(device=cuda_dev).manual_seed(7)
    q, k, v = ((torch.randn((3, 200, 64), generator=g, device=cuda_dev) * 0.3)
               .requires_grad_() for _ in range(3))
    got = torch.autograd.grad(torch.sin(tops.flash_attention_nhsd(
        q, k, v, attn, win, causal, glob)).sum(), (q, k, v))
    want = torch.autograd.grad(torch.sin(tfa.flash_attention_plain(
        q, k, v, attn, win, causal, glob)[0]).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-3)


@pytest.mark.cuda
def test_cuda_flash_refuses_what_it_cannot_run(cuda_dev):
    q = torch.zeros((2, 128, 32), device=cuda_dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_cuda(q, q, q)
    q = torch.zeros((2, 128, 64), device=cuda_dev)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_cuda(q.half(), q.half(), q.half())
