"""The port's SSM (repro_torch.models.mamba) against the JAX package's
(repro.models.mamba), on the CPU, at ``hymba_1_5b`` SMOKE (f32, d 64, 4
heads of width 32, state 4).

Weights are the reference's ``init_params``, unit 0's ``hybrid.ssm``,
carried across by ``interop`` (``A_log`` drawn from N(−1, 0.3²), so the
per-head decay differs between heads and a chunk's decay span stays under
f32's exp limit, where the reference's gradients are finite); inputs come
from a seeded numpy generator.  The scan runs at S = 64 (one chunk) and
S = 256 (two chunks of 128).

Tolerances: the forward and the final state within 1e-5 of the reference
output's largest magnitude (f32 sums in another order); the gradients of
a fixed random projection of the output within 1e-4 of the largest
magnitude of each reference gradient, wherever the reference's are
finite; the decode recurrence run token by token against the chunked
scan within 1e-5 of the largest magnitude (another algorithm, the same
arithmetic type).  The masked-exp case (ROADMAP Queue 3 item 13): with
``w_dt`` scaled ×40 a chunk's decay span passes f32's exp limit of 88.7;
the reference's ``A_log`` and ``w_dt`` gradients come out NaN, the port's
finite, and the two forwards agree within 1e-4 of the largest magnitude
(the ×40 step sizes take the outputs to ~1e3; 1.1e-5 of it measured);
in torch the reference's ``where(causal, exp(decay), 0)`` and the port's
``exp(decay.masked_fill(~causal, -inf))`` are equal bit for bit, and only
the first has a NaN gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import backbone as jb
from repro.models import mamba as jm
from repro.models.config import NO_SHARDING
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import backbone as tb
from repro_torch.models import mamba as tm

torch.set_num_threads(2)

NAMES = ("w_x", "w_z", "w_B", "w_C", "w_dt", "A_log", "w_out")


def carried(seed=0, dt_scale=1.0):
    """(jcfg, tcfg, the reference's unit-0 SSM params (jnp), the port's
    ``Mamba`` holding the same weights)."""
    jcfg, tcfg = jget_config("hymba_1_5b", smoke=True), get_config("hymba_1_5b", smoke=True)
    params = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(seed)))
    ssm = params["units"]["hybrid"]["ssm"]
    rng = np.random.default_rng(seed)
    ssm["A_log"] = rng.normal(-1.0, 0.3, size=ssm["A_log"].shape).astype(np.float32)
    ssm["w_dt"] = (np.asarray(ssm["w_dt"]) * dt_scale).astype(np.float32)
    model = interop.backbone_params_from_numpy(tcfg, params)
    ref = {k: jnp.asarray(np.asarray(v)[0]) for k, v in ssm.items()}
    return jcfg, tcfg, ref, model.units[0]["hybrid"].ssm


def x_in(b, s, d, seed=1):
    x = np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def near(got, want, scale_tol, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= scale_tol * scale, f"{what}: max |err| {err:.3g}, largest {scale:.3g}"


@pytest.mark.parametrize("s", [64, 256])
def test_scan_matches_reference(s):
    jcfg, tcfg, ref, p = carried()
    jx, tx = x_in(2, s, jcfg.d_model)
    jout, jst = jm.mamba_scan(jcfg, NO_SHARDING, ref, jx, return_state=True)
    with torch.no_grad():
        out, st = tm.mamba_scan(tcfg, p, tx, return_state=True)
        assert torch.equal(tm.mamba_prefill_state(tcfg, p, tx), st)
    assert out.shape == (2, s, jcfg.d_model) and st.shape == (2, 4, 4, 32)
    near(out, jout, 1e-5, "output")
    near(st, jst, 1e-5, "final state")


@pytest.mark.parametrize("s", [64, 256])
def test_scan_gradients_match_reference(s):
    jcfg, tcfg, ref, p = carried(seed=2)
    jx, tx = x_in(2, s, jcfg.d_model, seed=3)
    proj = np.random.default_rng(4).normal(size=(2, s, jcfg.d_model)).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jm.mamba_scan(jcfg, NO_SHARDING, params, x) * proj)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(ref, jx)
    tx.requires_grad_(True)
    loss = torch.sum(tm.mamba_scan(tcfg, p, tx) * torch.from_numpy(proj))
    grads = torch.autograd.grad(loss, [getattr(p, n) for n in NAMES] + [tx])
    for name, g in zip(NAMES, grads):
        want = np.asarray(jg[name])
        assert np.isfinite(want).all()
        near(g, want.T if want.ndim == 2 else want, 1e-4, f"grad {name}")
    near(grads[-1], jgx, 1e-4, "grad x")


def test_decode_steps_equal_the_scan():
    """Two chunks (S = 256) fed one token at a time through
    ``mamba_decode_step`` from ``mamba_decode_init``: each step's output is
    the scan's at that position, and the last state is its final state."""
    jcfg, tcfg, ref, p = carried(seed=5)
    s = 256
    _, tx = x_in(2, s, jcfg.d_model, seed=6)
    with torch.no_grad():
        out, st = tm.mamba_scan(tcfg, p, tx, return_state=True)
        state = tm.mamba_decode_init(tcfg, 2)
        steps = []
        for t in range(s):
            y, state = tm.mamba_decode_step(tcfg, p, tx[:, t:t + 1], state)
            steps.append(y)
    near(torch.cat(steps, dim=1), out.numpy(), 1e-5, "decode outputs")
    near(state, st.numpy(), 1e-5, "decode state")
    # and the reference's decode step agrees with the port's
    jy, jst = jm.mamba_decode_step(jcfg, NO_SHARDING, ref, jnp.asarray(tx[:, :1].numpy()),
                                   jm.mamba_decode_init(jcfg, 2))
    with torch.no_grad():
        y, st1 = tm.mamba_decode_step(tcfg, p, tx[:, :1], tm.mamba_decode_init(tcfg, 2))
    near(y, jy, 1e-5, "one decode step")
    near(st1, jst, 1e-5, "one decode step's state")


def test_masked_exp_keeps_the_gradient_finite():
    """ROADMAP Queue 3 item 13: past f32's exp limit inside a chunk the
    reference's gradient is NaN and the port's finite; the forwards equal."""
    jcfg, tcfg, ref, p = carried(seed=7, dt_scale=40.0)
    s = 128
    jx, tx = x_in(2, s, jcfg.d_model, seed=8)
    dt = jax.nn.softplus(jnp.einsum("bsd,dh->bsh", jx, ref["w_dt"]))
    span = float((jnp.exp(ref["A_log"]) * dt).sum(axis=1).max())
    assert span > 88.7, span                      # exp(span) is inf in f32

    def jloss(params):
        return jnp.sum(jm.mamba_scan(jcfg, NO_SHARDING, params, jx))

    jout = jm.mamba_scan(jcfg, NO_SHARDING, ref, jx)
    jg = jax.grad(jloss)(ref)
    assert np.isnan(np.asarray(jg["A_log"])).any() and np.isnan(np.asarray(jg["w_dt"])).any()
    out = tm.mamba_scan(tcfg, p, tx)
    assert np.isfinite(np.asarray(jout)).all()
    near(out, jout, 1e-4, "output")          # outputs ~1e3 at ×40 step sizes
    grads = torch.autograd.grad(out.sum(), [getattr(p, n) for n in NAMES])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[NAMES.index("A_log")].abs().max()) > 0

    # the two formulas on this input's within-chunk decay, in torch
    a = (-torch.exp(p.A_log) * torch.nn.functional.softplus(
        torch.nn.functional.linear(tx, p.w_dt))).detach().requires_grad_(True)
    acs = torch.cumsum(a, dim=1)
    decay = acs[:, :, None, :] - acs[:, None, :, :]
    causal = torch.ones((s, s), dtype=torch.bool).tril()[None, :, :, None]
    masked = torch.exp(decay.masked_fill(~causal, -float("inf")))
    where = torch.where(causal, torch.exp(decay), torch.zeros(()))
    assert torch.isinf(torch.exp(decay)).any() and torch.equal(masked, where)
    assert torch.isnan(torch.autograd.grad(where.sum(), a, retain_graph=True)[0]).any()
    assert torch.isfinite(torch.autograd.grad(masked.sum(), a)[0]).all()


def test_sequence_length_rule():
    """Past one chunk a sequence must be a multiple of 128, as the
    reference asserts; up to 128 any length is one chunk."""
    _, tcfg, _, p = carried()
    with torch.no_grad():
        assert tm.mamba_scan(tcfg, p, torch.zeros(1, 100, tcfg.d_model)).shape == (1, 100, 64)
        with pytest.raises(ValueError, match="multiple of"):
            tm.mamba_scan(tcfg, p, torch.zeros(1, 200, tcfg.d_model))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jget_config("hymba_1_5b", smoke=True))
    assert tm.mamba_heads(tcfg) == jm.mamba_heads(jget_config("hymba_1_5b", smoke=True))
    assert tb.unit_structure(tcfg) == jb.unit_structure(jget_config("hymba_1_5b", smoke=True))
