"""The port's token-DQN learner (repro_torch.agents.token_dqn), its Adam
and EMA (repro_torch.optim.adam) and the token MDP
(repro_torch.envs.token_mdp) against the JAX package, on the same
numpy-seeded inputs.

``train_step`` runs at InternLM2-1.8B SMOKE size (f32, 2 layers, vocab
256) from one ``TrainState`` carried over by
``interop.train_state_from_numpy``, on a (4, 128) batch, for accum 1 and
2, DDQN and max, naive and flash attention (the reference's Pallas
kernels in interpret mode, the port's plain version); and at Hymba-1.5B
SMOKE (hybrid, naive and flash; ``A_log`` set to −1 on both sides, so a
128-token chunk's decay span stays under f32's exp limit, past which the
reference's gradient is NaN: ROADMAP Queue 3 item 13) and xLSTM-125M
SMOKE (ssm).  Tolerances: the
two sides sum f32 products in different orders, so loss, grad norm, Q
mean and the per-sequence |TD| are held at rtol 1e-5 (atol 1e-6).  The
Adam moments carry the gradients, whose entries that cancel in their sums
have a large relative error: m and v are held at rtol 1e-4 plus an atol
of 1e-5 of the tensor's largest magnitude (the worst case measured is
3.1e-6 of it).  The new parameters at atol 1e-7 wherever the reference's
clipped gradient exceeds 1e-6, 100× Adam's eps, where the step
lr·g/(|g| + eps) is lr = 3e-5 to within 1 %; where the gradient is
smaller the step follows its rounding noise (1.3e-6 measured) and is
only bounded by 2·lr.  The target, which takes τ = 0.01 of the online
network, at atol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents import token_dqn as jdqn
from repro.configs import get_config as jget_config
from repro.envs import token_mdp as jmdp
from repro.models.config import NO_SHARDING
from repro.optim import adam as jadam
from repro_torch import interop
from repro_torch.agents import token_dqn as tdqn
from repro_torch.configs import get_config as tget_config
from repro_torch.envs import token_mdp as tmdp
from repro_torch.models.config import NO_SHARDING as NO_SHARDING_T
from repro_torch.optim import adam as tadam

torch.set_num_threads(2)


def _batch(cfg, b=4, s=128, seed=0):
    rng = np.random.default_rng(seed)
    dones = np.zeros((b, s), np.float32)
    dones[:, 63] = 1.0                      # a terminal mid-segment
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "actions": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "rewards": rng.uniform(0, 1, (b, s)).astype(np.float32),
            "dones": dones,
            "is_weights": rng.uniform(0.5, 1.0, b).astype(np.float32)}


def _close_scaled(got, want, what):
    want = np.asarray(want, np.float64)
    _close(got, want, 1e-4, 1e-5 * float(np.abs(want).max()), what)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("accum,double_q,impl", [
    (1, True, "naive"), (2, True, "naive"), (1, False, "naive"),
    (1, True, "flash"), (2, False, "flash")])
def test_train_step_matches_reference(accum, double_q, impl):
    jcfg = dataclasses.replace(jget_config("internlm2_1_8b", smoke=True), attn_impl=impl)
    tcfg_j = jdqn.TokenDQNConfig(double_q=double_q, accum=accum)
    jstate = jdqn.init_train_state(jcfg, tcfg_j, jax.random.PRNGKey(3))
    # a target other than the online network, so that DDQN and max differ
    jstate = jstate._replace(target=jdqn.init_train_state(jcfg, tcfg_j,
                                                          jax.random.PRNGKey(4)).params)
    batch = _batch(jcfg)
    jnew, jmetrics, jtds = jdqn.train_step(jcfg, NO_SHARDING, tcfg_j, jstate,
                                           {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = dataclasses.replace(tget_config("internlm2_1_8b", smoke=True), attn_impl=impl)
    check_step(cfg, tdqn.TokenDQNConfig(double_q=double_q, accum=accum), jstate, batch,
               jnew, jmetrics, jtds)


@pytest.mark.parametrize("arch,impl", [("hymba_1_5b", "naive"), ("hymba_1_5b", "flash"),
                                       ("xlstm_125m", "naive")])
def test_train_step_matches_reference_hybrid_and_ssm(arch, impl):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), attn_impl=impl)
    tcfg_j = jdqn.TokenDQNConfig()
    jstate = jdqn.init_train_state(jcfg, tcfg_j, jax.random.PRNGKey(3))
    target = jdqn.init_train_state(jcfg, tcfg_j, jax.random.PRNGKey(4)).params
    if jcfg.family == "hybrid":
        def calm(params):
            ssm = dict(params["units"]["hybrid"]["ssm"])
            ssm["A_log"] = jnp.full_like(ssm["A_log"], -1.0)
            hybrid = dict(params["units"]["hybrid"], ssm=ssm)
            return dict(params, units=dict(params["units"], hybrid=hybrid))

        jstate, target = jstate._replace(params=calm(jstate.params)), calm(target)
    jstate = jstate._replace(target=target)
    batch = _batch(jcfg)
    jnew, jmetrics, jtds = jdqn.train_step(jcfg, NO_SHARDING, tcfg_j, jstate,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(jnew.params))
    cfg = dataclasses.replace(tget_config(arch, smoke=True), attn_impl=impl)
    check_step(cfg, tdqn.TokenDQNConfig(), jstate, batch, jnew, jmetrics, jtds)


def check_step(cfg, tcfg, jstate, batch, jnew, jmetrics, jtds):
    """The port's ``train_step`` from the reference's ``jstate`` on ``batch``
    against the reference's result, under the rules of the module
    docstring."""
    state = interop.train_state_from_numpy(cfg, jax.device_get(jstate))
    new, metrics, tds = tdqn.train_step(cfg, NO_SHARDING_T, tcfg, state,
                                        {k: torch.from_numpy(v) for k, v in batch.items()})
    want = interop.train_state_from_numpy(cfg, jax.device_get(jnew))

    for key in ("loss", "grad_norm", "q_mean"):
        _close(float(metrics[key]), float(jmetrics[key]), 1e-5, 1e-6, key)
    _close(tds.numpy(), np.asarray(jtds), 1e-5, 1e-6, "per-sequence |TD|")
    assert int(new.step) == int(jnew.step) == 1 and int(new.opt.count) == 1
    names = [n for n, _ in new.params.named_parameters()]
    lr = tcfg.opt.lr
    for name, a, b, m in zip(names, new.params.parameters(), want.params.parameters(),
                             want.opt.m):
        sure = m.abs() > 0.1 * 1e-6          # m = (1 - b1)·g after one step
        err = (a.detach() - b.detach()).abs()
        assert float(err[sure].max()) <= 1e-7, f"params {name}: {float(err[sure].max())}"
        assert float(err.max()) <= 2 * lr + 1e-7, f"params {name}: {float(err.max())}"
    for name, a, b in zip(names, new.target.parameters(), want.target.parameters()):
        _close(a, b, 0, 1e-7, f"target {name}")
    for name, a, b in zip(names, new.opt.m, want.opt.m):
        _close_scaled(a, b, f"m {name}")
    for name, a, b in zip(names, new.opt.v, want.opt.v):
        _close_scaled(a, b, f"v {name}")
    # the step moved the online network
    before = interop.train_state_from_numpy(cfg, jax.device_get(jstate))
    assert max(float((a.detach() - b.detach()).abs().max()) for a, b in
               zip(new.params.parameters(), before.params.parameters())) > 1e-5


def test_td_loss_with_patch_embeds_matches_reference():
    """Phi-3-vision SMOKE: ``_td_loss`` with ``extra_embeds`` (vlm's patches,
    prepended and then cut from the logits at the patch offset) against the
    reference's: loss, per-sequence |TD|, Q mean and every gradient, the
    patches' own included (the rules of the module docstring)."""
    jcfg, cfg = jget_config("phi_3_vision_4_2b", smoke=True), tget_config("phi_3_vision_4_2b",
                                                                          smoke=True)
    jt = jdqn.TokenDQNConfig()
    jstate = jdqn.init_train_state(jcfg, jt, jax.random.PRNGKey(3))
    jstate = jstate._replace(target=jdqn.init_train_state(jcfg, jt, jax.random.PRNGKey(4)).params)
    batch = _batch(jcfg, b=2, s=120)
    batch["extra_embeds"] = (np.random.default_rng(5).normal(
        size=(2, jcfg.num_patch_tokens, jcfg.d_model)) * 0.1).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, extra):
        return jdqn._td_loss(jcfg, jt, params, jstate.target, NO_SHARDING,
                             dict(jbatch, extra_embeds=extra))

    (jloss, (jseq_td, jq)), (jgrads, jgx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(jstate.params, jbatch["extra_embeds"])
    jgrads = jax.device_get(jgrads)

    state = interop.train_state_from_numpy(cfg, jax.device_get(jstate))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["extra_embeds"].requires_grad_(True)
    loss, aux = tdqn._td_loss(cfg, tdqn.TokenDQNConfig(), state.params, state.target, tb)
    params = list(state.params.parameters())
    grads = torch.autograd.grad(loss, params + [tb["extra_embeds"]])
    assert aux["td"].shape == (2, 120)
    _close(float(loss.detach()), float(jloss), 1e-5, 1e-6, "loss")
    _close(aux["seq_td"].numpy(), np.asarray(jseq_td), 1e-5, 1e-6, "per-sequence |TD|")
    _close(float(aux["q_mean"]), float(jq), 1e-5, 1e-6, "q mean")
    for (name, _), g in zip(state.params.named_parameters(), grads):
        _close_scaled(g.numpy(), interop.backbone_leaf(jgrads, name), f"grad {name}")
    _close_scaled(grads[-1].numpy(), np.asarray(jgx), "grad of the patch embeddings")
    assert float(grads[-1].abs().max()) > 0


def test_double_q_and_max_targets_differ():
    """With a target other than the online network, DDQN's loss is not the
    max rule's (at init the two coincide: target = online)."""
    cfg = tget_config("internlm2_1_8b", smoke=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    losses = []
    for double_q in (True, False):
        tcfg = tdqn.TokenDQNConfig(double_q=double_q)
        state = tdqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0))
        other = tdqn.init_train_state(cfg, tcfg, torch.Generator().manual_seed(1))
        state = state._replace(target=other.params.requires_grad_(False))
        losses.append(float(tdqn.train_step(cfg, NO_SHARDING_T, tcfg, state, batch)[1]["loss"]))
    assert abs(losses[0] - losses[1]) > 1e-3 * abs(losses[1]), losses


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_ema_update_bit_exact(dtype):
    """t·(1-τ) + o·τ rounds once, as the reference: a bf16 target equal to
    online stays bit-identical (a fused or in-place bf16 form changes
    ~43 % of its elements), and random trees agree bit for bit.  The port
    gets its own copy of every input: ``from_numpy(x).to(float32)`` shares
    x's buffer, ``jnp.asarray`` may alias it too, and JAX reads it
    asynchronously, so an in-place write into x could race the
    reference's read."""
    rng = np.random.default_rng(0)
    t = rng.normal(size=(3, 4096)).astype(np.float32)
    o = rng.normal(size=(3, 4096)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    for target, online in ((t, t), (t, o)):
        want = jadam.ema_update([jnp.asarray(target, dtype)], [jnp.asarray(online, dtype)], 0.01)
        got = [torch.from_numpy(target.copy()).to(tdt)]
        tadam.ema_update(got, [torch.from_numpy(online.copy()).to(tdt)], 0.01)
        np.testing.assert_array_equal(got[0].float().numpy(),
                                      np.asarray(want[0], np.float32))
    # a target updated toward a clone of itself: the reference's result bit
    # for bit; in bf16 that is the target itself (f32's t·(1-τ) + t·τ rounds
    # and is not)
    same = torch.from_numpy(t.copy()).to(tdt)
    tadam.ema_update([same], [same.clone()], 0.01)
    want = jadam.ema_update([jnp.asarray(t, dtype)], [jnp.asarray(t, dtype)], 0.01)
    np.testing.assert_array_equal(same.float().numpy(), np.asarray(want[0], np.float32))
    if tdt == torch.bfloat16:
        assert torch.equal(same, torch.from_numpy(t.copy()).to(tdt))


def test_adam_bf16_params_take_the_f32_step_once():
    """bf16 parameters with bf16 gradients: clip, moments and step in f32,
    one rounding into the parameter — the reference's new parameters bit
    for bit; its grad norm and moments at rtol 1e-5 (the two sum the
    squares of the norm in different orders)."""
    rng = np.random.default_rng(1)
    p = [rng.normal(size=(64, 33)).astype(np.float32), rng.normal(size=(77,)).astype(np.float32)]
    g = [rng.normal(size=x.shape).astype(np.float32) * 3 for x in p]
    cfg = jadam.AdamConfig(lr=1e-2)
    jp = [jnp.asarray(x, jnp.bfloat16) for x in p]
    jnew, jst, jnorm = jadam.update([jnp.asarray(x, jnp.bfloat16) for x in g],
                                    jadam.init(jp, cfg), jp, cfg)
    tp = [torch.from_numpy(x).bfloat16() for x in p]
    tst, tnorm = tadam.update([torch.from_numpy(x).bfloat16() for x in g],
                              tadam.init(tp, tadam.AdamConfig(lr=1e-2)), tp,
                              tadam.AdamConfig(lr=1e-2))
    assert all(x.dtype == torch.bfloat16 for x in tp)
    _close(float(tnorm), float(jnorm), 1e-5, 0, "grad norm")
    for a, b in zip(tp, jnew):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    for a, b in zip(tst.m + tst.v, list(jst.m) + list(jst.v)):
        _close(a, b, 1e-5, 0, "moments")


def test_token_mdp_matches_reference():
    """One table: the same optimal reward, and the same next token and
    reward from the same Gumbel noise."""
    n, vocab = 16, 300
    key = jax.random.PRNGKey(5)
    jreset, jstep, joptimal = jmdp.make(jmdp.TokenMDPSpec(vocab=vocab), key, n)
    jstate, jtok = jreset(jax.random.PRNGKey(6))
    table = torch.from_numpy(np.asarray(jstate.table))
    reset, step, optimal = tmdp.make(tmdp.TokenMDPSpec(vocab=vocab),
                                     torch.Generator().manual_seed(0), n, table=table)
    _close(optimal(), joptimal(), 1e-6, 0, "optimal reward")
    state = tmdp.TokenMDPState(torch.from_numpy(np.asarray(jtok)).long(), table)
    actions = np.random.default_rng(7).integers(0, vocab, n).astype(np.int32)
    for i in range(4):
        k = jax.random.PRNGKey(100 + i)
        jstate, jnxt, jrew, jdone = jstep(jstate, jnp.asarray(actions), k)
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(k, (n, vocab))))
        state, nxt, rew, done = step(state, torch.from_numpy(actions).long(), noise=noise)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        assert not bool(done.any()) and not bool(np.asarray(jdone).any())
        actions = np.asarray(jnxt).astype(np.int32)     # reward 1 on the next step


def test_token_mdp_table_and_sampling_statistics():
    """The port's own table: Gumbel/concentration logits (mean γ/c), and
    Gumbel-max draws that follow the softmax of the row."""
    v, conc = 64, 0.3
    gen = torch.Generator().manual_seed(0)
    reset, step, optimal = tmdp.make(tmdp.TokenMDPSpec(vocab=v, concentration=conc), gen, 4096)
    state, tok = reset(gen)
    assert tok.shape == (4096,) and int(tok.min()) >= 0 and int(tok.max()) < v
    table = state.table
    assert table.shape == (v, v) and table.dtype == torch.float32
    assert abs(float(table.mean()) - 0.5772 / conc) < 0.1
    state = tmdp.TokenMDPState(torch.zeros(4096, dtype=torch.long), table)
    _, nxt, _, _ = step(state, torch.zeros(4096, dtype=torch.long), gen)
    freq = torch.bincount(nxt, minlength=v).double() / 4096
    probs = torch.softmax(table[0].double(), -1)
    assert float((freq - probs).abs().max()) < 0.04
    want = float(torch.softmax(table.double(), -1).max(-1).values.mean())
    assert abs(optimal() - want) < 1e-6
