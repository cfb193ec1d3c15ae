"""Each CUDA kernel against its plain PyTorch version, on an NVIDIA GPU.

Every test here needs the card: marked ``cuda``, each skips without one.
The file imports no JAX, so it also runs on a GPU machine that has none.
tests/conftest.py imports jax, so there run it without the conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Shapes: the main path's replay (50,000, K=128, B=64), the Nature-DQN
replay (10^6, K=128, B=512), K=8 and K=256 at 10^5, and a 10-leaf tree
whose tail draws clamp.  Tolerances are the rules of
repro_torch.kernels.parity: sampled indices under the fp-tie rule and
priorities exact where the indices agree; rows bit-exact; the update's
leaves bit for bit and each interior level at rtol 1e-5 plus 1e-6 of its
own magnitude.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import sumtree as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity

SHAPES = [(50_000, 128, 64), (1_000_000, 128, 512), (100_000, 8, 512),
          (100_000, 256, 512), (10, 4, 64)]


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
@pytest.mark.parametrize("capacity,fanout,batch", SHAPES)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape", [(5000,), (5000, 4), (5000, 3, 5), (5000, 33)])
def test_cuda_gather_bit_exact(cuda_dev, dtype, shape):
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    if dtype == torch.int32:
        x = torch.randint(0, 2**31 - 1, shape, generator=g, device=cuda_dev,
                          dtype=torch.int32)
    else:
        x = torch.randn(shape, generator=g, device=cuda_dev).to(dtype)
    idx = torch.randint(0, shape[0], (517,), generator=g, device=cuda_dev)
    torch.testing.assert_close(tops.prioritized_gather(x, idx), x[idx], rtol=0, atol=0)


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
    torch.cuda.synchronize()
    assert parity.tree_mismatch(ts, got, want) == []
    assert tst.check_invariant(ts, got)
