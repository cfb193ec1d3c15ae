"""The port's checkpoint manager (repro_torch.checkpoint.manager): the
first six tests of tests/test_checkpoint.py on a dict of named tensors,
a bf16 round trip bit for bit, a token-DQN ``TrainState`` restored in
place, and a checkpoint that the JAX package's manager reads."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params/w": torch.randn((8, 16), generator=g),
            "params/b": torch.zeros((16,), dtype=torch.bfloat16),
            "opt/0": torch.ones((3,)),
            "opt/1": torch.tensor(7, dtype=torch.int32)}


def zeros_like(t):
    return {k: torch.zeros_like(v) for k, v in t.items()}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    mgr.save(10, t)
    step, restored = mgr.restore_latest(zeros_like(t))
    assert step == 10
    for k in t:
        assert torch.equal(restored[k], t[k]) and restored[k].dtype == t[k].dtype


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree(s))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]     # keep-last-2 GC
    _, restored = mgr.restore_latest(zeros_like(tree()))
    assert torch.equal(restored["params/w"], tree(4)["params/w"])


def test_crash_safe_tmp_not_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, tree())
    os.makedirs(tmp_path / "step_6.tmp")     # a crash mid-save
    assert mgr.all_steps() == [5]
    step, _ = mgr.restore_latest(zeros_like(tree()))
    assert step == 5


def test_resave_same_step_replaces_committed_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, tree(0))
    mgr.save(7, tree(1))
    assert mgr.all_steps() == [7]
    _, restored = mgr.restore_latest(zeros_like(tree()))
    assert torch.equal(restored["params/w"], tree(1)["params/w"])


def test_extra_blobs_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, tree(), extra={"service.json": b'{"appends": 7}',
                              "params.bin": b"\x00\x01\x02"})
    assert mgr.read_extra(3, "service.json") == b'{"appends": 7}'
    assert mgr.read_extra(3, "params.bin") == b"\x00\x01\x02"
    assert mgr.read_extra(3, "absent.bin") is None
    step, restored = mgr.restore_latest(zeros_like(tree()))
    assert step == 3 and torch.equal(restored["params/w"], tree()["params/w"])
    mgr.save(4, tree(1))
    assert mgr.read_extra(4, "service.json") is None
    for bad in ("arrays.npz", "manifest.json", "a/b.json"):
        with pytest.raises(ValueError):
            mgr.save(5, tree(), extra={bad: b"x"})
    assert 5 not in mgr.all_steps()


def test_manifest_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree())
    with pytest.raises(ValueError):
        mgr.restore(1, {"params/w": torch.zeros((8, 16))})      # missing keys
    bad_shape = zeros_like(tree())
    bad_shape["params/w"] = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad_shape)


@pytest.mark.parametrize("saved,into", [(torch.float32, torch.bfloat16),
                                        (torch.bfloat16, torch.float32),
                                        (torch.int32, torch.int64)])
def test_restore_refuses_another_dtype(tmp_path, saved, into):
    """A tensor restores only into the dtype it was saved in: a cast would
    not come back bit for bit."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones((4, 4), dtype=saved)})
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore(1, {"x": torch.zeros((4, 4), dtype=into)})
    assert mgr.restore(1, {"x": torch.zeros((4, 4), dtype=saved)})["x"].eq(1).all()


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    """bf16 is stored as its uint16 bit pattern ("bfloat16" in the
    manifest): every value comes back, subnormals, inf and nan included."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16)
    t = {"x": bits.view(torch.bfloat16).reshape(256, 256).clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, t)
    out = mgr.restore(2, {"x": torch.zeros((256, 256), dtype=torch.bfloat16)})["x"]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), t["x"].view(torch.int16))


def test_train_state_restores_in_place(tmp_path):
    cfg = get_config("internlm2_1_8b", smoke=True)
    tcfg = token_dqn.TokenDQNConfig()
    a = token_dqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0))
    b = token_dqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(1))
    a.opt.m[0].fill_(0.5)
    a.step.fill_(3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state_tensors(a))
    targets = state_tensors(b)
    before = {k: t.data_ptr() for k, t in targets.items()}
    step, got = mgr.restore_latest(targets)
    assert step == 3
    for k, t in state_tensors(a).items():
        assert torch.equal(got[k], t) and got[k].data_ptr() == before[k]
    assert int(b.step) == 3 and torch.equal(b.opt.m[0], a.opt.m[0])


def test_reference_manager_reads_the_port_checkpoint(tmp_path):
    """Same layout: arrays.npz + manifest.json keyed by name, readable by
    repro.checkpoint.manager for the dtypes numpy has."""
    t = {k: v for k, v in tree(2).items() if v.dtype != torch.bfloat16}
    CheckpointManager(str(tmp_path)).save(4, t)
    example = {k: jnp.zeros(tuple(v.shape), jnp.asarray(v.numpy()).dtype) for k, v in t.items()}
    step, restored = JaxManager(str(tmp_path)).restore_latest(example)
    assert step == 4
    for k, v in t.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v.numpy())
