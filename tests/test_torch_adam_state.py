"""The port's Adam with bf16 moments (``AdamConfig.state_dtype``) against
``repro.optim.adam`` on the CPU.

Five ``update``s from the same numpy-seeded parameters and gradients,
f32 and bf16 parameters, the clip on (1.0, and engaged: the gradients'
norm is ~560) and off, weight decay 0 and 0.01.  The new parameters and
both moments are held to the reference's bit for bit.  The grad norm
sums its squares in another order than XLA's (torch's and XLA's
reductions differ), so it is held at rtol 1e-6 (the worst measured is
1 ulp); the update itself is held bit for bit from the reference's norm,
which the test passes to the port's ``update`` in place of its own.  With
the clip off the norm does not enter the step, and the port's own
``update`` runs unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro_torch.models.config import NO_SHARDING as NO_SHARDING_T
from repro_torch.optim import adam as tadam

SHAPES = [(64, 33), (77,), (128, 256), (5,)]
STEPS = 5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 3).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _same(got, want) -> bool:
    return all(np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
               for a, b in zip(got, want, strict=True))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_bf16_moments_match_reference_bit_for_bit(param_dtype, clip, weight_decay,
                                                   monkeypatch):
    jdt, tdt = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    kw = dict(lr=1e-2, grad_clip=clip, weight_decay=weight_decay, state_dtype="bfloat16")
    jcfg, tcfg = jadam.AdamConfig(**kw), tadam.AdamConfig(**kw)
    params, grads = _inputs()
    jp = [jnp.asarray(x, jdt) for x in params]
    jst = jadam.init(jp, jcfg)
    tp = [torch.from_numpy(x.copy()).to(tdt) for x in params]
    tst = tadam.init(tp, tcfg)
    own_norm = tadam.global_norm
    for step, g in enumerate(grads):
        jp, jst, jnorm = jadam.update([jnp.asarray(x, jdt) for x in g], jst, jp, jcfg)
        tg = [torch.from_numpy(x.copy()).to(tdt) for x in g]
        np.testing.assert_allclose(float(own_norm(tg)), float(jnorm), rtol=1e-6)
        if clip:
            pinned = torch.tensor(float(jnorm), dtype=torch.float32)
            monkeypatch.setattr(tadam, "global_norm", lambda xs, n=pinned: n)
        tst, tnorm = tadam.update(tg, tst, tp, tcfg)
        monkeypatch.setattr(tadam, "global_norm", own_norm)
        assert all(p.dtype == tdt for p in tp)
        assert all(x.dtype == torch.bfloat16 for x in tst.m + tst.v)
        assert _same(tp, jp), f"parameters differ after step {step + 1}"
        assert _same(tst.m, jst.m), f"m differs after step {step + 1}"
        assert _same(tst.v, jst.v), f"v differs after step {step + 1}"
        assert int(tst.count) == int(jst.count) == step + 1


@pytest.mark.parametrize("state_dtype,want", [(None, torch.float32),
                                              ("float32", torch.float32),
                                              ("bfloat16", torch.bfloat16)])
def test_init_dtypes_match_reference(state_dtype, want):
    params = [torch.zeros((3, 4), dtype=torch.bfloat16), torch.zeros((5,))]
    st = tadam.init(params, tadam.AdamConfig(state_dtype=state_dtype))
    ref = jadam.init([jnp.zeros((3, 4), jnp.bfloat16), jnp.zeros((5,))],
                     jadam.AdamConfig(state_dtype=state_dtype))
    assert all(x.dtype == want for x in st.m + st.v)
    assert [str(x.dtype).removeprefix("torch.") for x in st.m + st.v] == \
        [str(x.dtype) for x in list(ref.m) + list(ref.v)]
    assert st.count.dtype == torch.int32 and int(st.count) == 0


def _f32_update_as_before(grads, state, params, cfg):
    """The f32-moment step as it stood before ``state_dtype`` (in place,
    ``alpha=`` and ``addcmul``), kept here to hold that path unchanged."""
    gnorm = tadam.global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = state.count + 1
    b1c, b2c = 1.0 - cfg.b1 ** count.float(), 1.0 - cfg.b2 ** count.float()
    g = torch._foreach_mul([x.float() for x in grads], scale)
    torch._foreach_mul_(state.m, cfg.b1)
    torch._foreach_add_(state.m, g, alpha=1 - cfg.b1)
    torch._foreach_mul_(state.v, cfg.b2)
    torch._foreach_addcmul_(state.v, g, g, value=1 - cfg.b2)
    denom = torch._foreach_div(state.v, b2c)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    step = torch._foreach_div(state.m, b1c)
    torch._foreach_mul_(step, cfg.lr)
    torch._foreach_div_(step, denom)
    torch._foreach_add_(step, params, alpha=cfg.lr * cfg.weight_decay)
    torch._foreach_sub_(params, step)
    return tadam.AdamState(count, state.m, state.v), gnorm


@pytest.mark.parametrize("state_dtype", [None, "float32"])
def test_f32_moments_path_unchanged(state_dtype):
    """f32 moments (``state_dtype`` None or "float32") take the in-place
    path as before, bit for bit over five steps."""
    params, grads = _inputs(seed=3)
    cfg = tadam.AdamConfig(lr=1e-2, weight_decay=0.01, state_dtype=state_dtype)
    got = [torch.from_numpy(x.copy()) for x in params]
    want = [torch.from_numpy(x.copy()) for x in params]
    gst, wst = tadam.init(got, cfg), tadam.init(want, cfg)
    for g in grads:
        gst, gnorm = tadam.update([torch.from_numpy(x) for x in g], gst, got, cfg)
        wst, wnorm = _f32_update_as_before([torch.from_numpy(x) for x in g], wst, want, cfg)
        assert torch.equal(gnorm, wnorm)
    for a, b in zip(got + gst.m + gst.v, want + wst.m + wst.v, strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_state_dtype_field_matches_reference():
    assert [f.name for f in dataclasses.fields(tadam.AdamConfig)] == \
        [f.name for f in dataclasses.fields(jadam.AdamConfig)]
    assert tadam.AdamConfig().state_dtype is jadam.AdamConfig().state_dtype is None


# -- bf16 moments through interop and the checkpoint -------------------------------


def _reference_bf16_state():
    """A reference token-DQN ``TrainState`` with bf16 moments after one
    train step (non-zero moments), at InternLM2-1.8B SMOKE."""
    import jax

    from repro.agents import token_dqn as jdqn
    from repro.configs import get_config as jget_config
    from repro.models.config import NO_SHARDING

    jcfg = jget_config("internlm2_1_8b", smoke=True)
    jtcfg = jdqn.TokenDQNConfig(opt=jadam.AdamConfig(lr=1e-3, state_dtype="bfloat16"))
    state = jdqn.init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "actions": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "rewards": rng.uniform(0, 1, (b, s)).astype(np.float32),
             "dones": np.zeros((b, s), np.float32),
             "is_weights": np.ones((b,), np.float32)}
    state, _, _ = jdqn.train_step(jcfg, NO_SHARDING, jtcfg, state,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.device_get(state), batch


def test_interop_keeps_bf16_moments_bit_for_bit():
    from repro_torch import interop
    from repro_torch.configs import get_config

    jstate, _ = _reference_bf16_state()
    cfg = get_config("internlm2_1_8b", smoke=True)
    state = interop.train_state_from_numpy(cfg, jstate)
    names = [n for n, _ in state.params.named_parameters()]
    assert len(state.opt.m) == len(state.opt.v) == len(names)
    for name, m, v in zip(names, state.opt.m, state.opt.v):
        assert m.dtype == v.dtype == torch.bfloat16, name
        for got, tree in ((m, jstate.opt.m), (v, jstate.opt.v)):
            want = interop.backbone_leaf(tree, name)
            assert want.dtype.name == "bfloat16"
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                          err_msg=name)
    assert any(float(m.abs().max()) > 0 for m in state.opt.m)
    # the flat (MLP) form takes the same path
    opt = interop._adam_from_numpy(jstate.opt, lambda t: [interop.backbone_leaf(t, names[0])],
                                   "cpu")
    assert opt.m[0].dtype == torch.bfloat16 and torch.equal(opt.m[0], state.opt.m[0])


def test_checkpoint_restores_bf16_moments_bit_for_bit(tmp_path):
    from repro_torch.agents import token_dqn as tdqn
    from repro_torch.agents.base import state_tensors
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config

    cfg = get_config("internlm2_1_8b", smoke=True)
    tcfg = tdqn.TokenDQNConfig(opt=tadam.AdamConfig(lr=1e-3, state_dtype="bfloat16"))
    state = tdqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0))
    _, batch = _reference_bf16_state()
    state, _, _ = tdqn.train_step(cfg, NO_SHARDING_T, tcfg, state,
                                  {k: torch.from_numpy(v) for k, v in batch.items()})
    assert all(x.dtype == torch.bfloat16 for x in state.opt.m + state.opt.v)
    assert any(float(m.abs().max()) > 0 for m in state.opt.m)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tensors(state))
    fresh = tdqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(5))
    step, got = mgr.restore_latest(state_tensors(fresh))
    saved = state_tensors(state)
    assert step == 1 and sorted(got) == sorted(saved)
    for k, t in saved.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    # restored into the fresh state's own tensors
    assert all(x.dtype == torch.bfloat16 for x in fresh.opt.m + fresh.opt.v)
    assert all(torch.equal(a, b) for a, b in zip(fresh.opt.m + fresh.opt.v,
                                                 state.opt.m + state.opt.v))
