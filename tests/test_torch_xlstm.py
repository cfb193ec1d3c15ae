"""The port's xLSTM cells (repro_torch.models.xlstm) against the JAX
package's (repro.models.xlstm), on the CPU, at ``xlstm_125m`` SMOKE (f32,
d 64, 2 heads of width 32): the mLSTM of block 0 and the sLSTM of block 1.

Weights are the reference's ``init_params``, carried across by
``interop``; inputs and states come from a seeded numpy generator.  Each
function is held to the reference: the two step functions, the exact and
the chunked mLSTM forward (S = 128, two chunks of 64), the sLSTM forward,
both prefill states and both decode steps; and the gradients of a fixed
random projection of each output with respect to every weight, the input
and (for the steps) the state.

Tolerances: outputs and states within 1e-5 of the reference's largest
magnitude, gradients within 1e-4 of each reference gradient's largest
magnitude (f32 sums in another order; the stabilizer's ``maximum`` splits
its gradient at a tie as ``jnp.maximum`` does).  The decode steps run
token by token equal the exact forward and its final state within 1e-5
of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import backbone as jb
from repro.models import xlstm as jx
from repro.models.config import NO_SHARDING
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import xlstm as tx

torch.set_num_threads(2)

NAMES = {"mlstm": ("wq", "wk", "wv", "wi", "wf", "wo_gate", "w_out"),
         "slstm": ("wz", "wi", "wf", "wo", "rz", "ri", "rf", "ro", "w_out")}
BLOCK = {"mlstm": 0, "slstm": 1}


def carried(kind, seed=0):
    """(jcfg, tcfg, the reference's cell params (jnp), the port's cell)."""
    jcfg, tcfg = jget_config("xlstm_125m", smoke=True), get_config("xlstm_125m", smoke=True)
    params = jax.device_get(jb.init_params(jcfg, jax.random.PRNGKey(seed)))
    model = interop.backbone_params_from_numpy(tcfg, params)
    i = BLOCK[kind]
    ref = {k: jnp.asarray(v) for k, v in params["blocks"][i][kind].items()}
    return jcfg, tcfg, ref, model.blocks[i][kind]


def near(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3g}, largest {scale:.3g}"


def ref_grad(name, g):
    g = np.asarray(g)
    return g.T if g.ndim == 2 else g


def arrays(rng, *shapes, scale=1.0):
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def jt(xs):
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x).requires_grad_(True) for x in xs]


FORWARDS = {
    "mlstm exact": ("mlstm", jx.mlstm_forward, tx.mlstm_forward),
    "mlstm chunked": ("mlstm", jx.mlstm_forward_chunked, tx.mlstm_forward_chunked),
    "slstm": ("slstm", jx.slstm_forward, tx.slstm_forward),
}


@pytest.mark.parametrize("which", list(FORWARDS))
def test_forward_and_its_gradients_match(which):
    kind, jfwd, tfwd = FORWARDS[which]
    jcfg, tcfg, ref, p = carried(kind, seed=1)
    rng = np.random.default_rng(2)
    (x, proj) = arrays(rng, (2, 128, jcfg.d_model), (2, 128, jcfg.d_model))

    def jloss(params, xx):
        return jnp.sum(jfwd(jcfg, NO_SHARDING, params, xx) * proj)

    jout = jfwd(jcfg, NO_SHARDING, ref, jnp.asarray(x))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(ref, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tfwd(tcfg, p, xt)
    near(out, jout, 1e-5, f"{which} output")
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(proj)),
                                [getattr(p, n) for n in NAMES[kind]] + [xt])
    for name, g in zip(NAMES[kind], grads):
        near(g, ref_grad(name, jg[name]), 1e-4, f"{which} grad {name}")
    near(grads[-1], jgx, 1e-4, f"{which} grad x")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_state_and_decode_match(kind):
    """The prefill state after 40 tokens, one decode step from it, and the
    decode steps run token by token from the initial state against the
    exact forward and its final state."""
    jcfg, tcfg, ref, p = carried(kind, seed=3)
    rng = np.random.default_rng(4)
    (x,) = arrays(rng, (2, 41, jcfg.d_model))
    jpre = jx.mlstm_prefill_state if kind == "mlstm" else jx.slstm_prefill_state
    tpre = tx.mlstm_prefill_state if kind == "mlstm" else tx.slstm_prefill_state
    jdec = jx.mlstm_decode_step if kind == "mlstm" else jx.slstm_decode_step
    tdec = tx.mlstm_decode_step if kind == "mlstm" else tx.slstm_decode_step
    tinit = tx.mlstm_decode_init if kind == "mlstm" else tx.slstm_decode_init
    tfwd = tx.mlstm_forward if kind == "mlstm" else tx.slstm_forward
    jst = jpre(jcfg, ref, jnp.asarray(x[:, :40]))
    with torch.no_grad():
        st = tpre(tcfg, p, torch.from_numpy(x[:, :40]))
    for field, a, b in zip(st._fields, st, jst):
        near(a, b, 1e-5, f"prefill state {field}")
    jy, jnew = jdec(jcfg, NO_SHARDING, ref, jnp.asarray(x[:, 40:]), jst)
    with torch.no_grad():
        y, new = tdec(tcfg, p, torch.from_numpy(x[:, 40:]), st)
        near(y, jy, 1e-5, "decode output")
        for field, a, b in zip(new._fields, new, jnew):
            near(a, b, 1e-5, f"decode state {field}")
        # token by token ≡ the exact forward
        out, final = tfwd(tcfg, p, torch.from_numpy(x), return_state=True)
        state, ys = tinit(tcfg, 2), []
        for t in range(x.shape[1]):
            y_t, state = tdec(tcfg, p, torch.from_numpy(x[:, t:t + 1]), state)
            ys.append(y_t)
    near(torch.cat(ys, dim=1), out.numpy(), 1e-5, "decode outputs vs forward")
    for field, a, b in zip(state._fields, state, final):
        near(a, b.numpy(), 1e-5, f"decode state {field} vs forward")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_step_and_decode_gradients_match(kind):
    """One step function from a random state, with the gradients of a
    projection of (new state, output) w.r.t. the state, the inputs and the
    sLSTM's recurrent matrices; and one decode step from a prefilled state,
    with the gradients w.r.t. every weight and x."""
    jcfg, tcfg, ref, p = carried(kind, seed=5)
    rng = np.random.default_rng(6)
    h, hd = 2, 32
    b = 3
    if kind == "mlstm":
        state_np = arrays(rng, (b, h, hd, hd), (b, h, hd), scale=0.5) + [
            rng.normal(size=(b, h)).astype(np.float32)]
        ins = arrays(rng, (b, h, hd), (b, h, hd), (b, h, hd)) + [
            rng.normal(size=(b, h)).astype(np.float32),
            np.log(rng.uniform(0.3, 0.99, size=(b, h))).astype(np.float32)]
        jstate_t, jS = jx.MLSTMState, tx.MLSTMState
    else:
        state_np = arrays(rng, (b, h, hd), (b, h, hd)) + [
            rng.normal(size=(b, h, hd)).astype(np.float32),
            rng.normal(size=(b, h, hd)).astype(np.float32)]
        state_np[1] = np.abs(state_np[1]) + 0.5            # a positive normalizer
        ins = arrays(rng, *[(b, h, hd)] * 4)
        jstate_t, jS = jx.SLSTMState, tx.SLSTMState
    projs = [rng.normal(size=a.shape).astype(np.float32) for a in state_np] + [
        rng.normal(size=(b, h, hd)).astype(np.float32)]

    def jstep(params, state, xs):
        if kind == "mlstm":
            return jx.mlstm_step(jstate_t(*state), *xs)
        return jx.slstm_step(params, jstate_t(*state), *xs)

    def jloss(params, state, xs):
        new, out = jstep(params, state, xs)
        return sum(jnp.sum(a * w) for a, w in zip(list(new) + [out], projs))

    jst, tst = jt(state_np)
    jin, tin = jt(ins)
    jnew, jout = jstep(ref, jst, jin)
    jgp, jgs, jgi = jax.grad(jloss, argnums=(0, 1, 2))(ref, jst, jin)
    if kind == "mlstm":
        new, out = tx.mlstm_step(jS(*tst), *tin)
    else:
        new, out = tx.slstm_step(p, jS(*tst), *tin)
    near(out, jout, 1e-5, "step output")
    for field, a, c in zip(new._fields, new, jnew):
        near(a, c, 1e-5, f"step state {field}")
    loss = sum(torch.sum(a * torch.from_numpy(w)) for a, w in zip(list(new) + [out], projs))
    rec = [n for n in NAMES[kind] if n.startswith("r")]    # the sLSTM step's weights
    grads = torch.autograd.grad(loss, tst + tin + [getattr(p, n) for n in rec])
    for i, g in enumerate(grads[:len(tst)]):
        near(g, jgs[i], 1e-4, f"step grad state {i}")
    for i, g in enumerate(grads[len(tst):len(tst) + len(tin)]):
        near(g, jgi[i], 1e-4, f"step grad input {i}")
    for name, g in zip(rec, grads[len(tst) + len(tin):]):
        near(g, ref_grad(name, jgp[name]), 1e-4, f"step grad {name}")

    # one decode step from a prefilled state: gradients w.r.t. the weights and x
    (x, proj) = arrays(rng, (b, 5, jcfg.d_model), (b, 1, jcfg.d_model))
    jpre = jx.mlstm_prefill_state if kind == "mlstm" else jx.slstm_prefill_state
    jdec = jx.mlstm_decode_step if kind == "mlstm" else jx.slstm_decode_step
    tpre = tx.mlstm_prefill_state if kind == "mlstm" else tx.slstm_prefill_state
    tdec = tx.mlstm_decode_step if kind == "mlstm" else tx.slstm_decode_step
    jstate = jpre(jcfg, ref, jnp.asarray(x[:, :4]))

    def jdloss(params, xx):
        return jnp.sum(jdec(jcfg, NO_SHARDING, params, xx, jstate)[0] * proj)

    jgp, jgx = jax.grad(jdloss, argnums=(0, 1))(ref, jnp.asarray(x[:, 4:]))
    with torch.no_grad():
        state = tpre(tcfg, p, torch.from_numpy(x[:, :4]))
    xt = torch.from_numpy(x[:, 4:]).requires_grad_(True)
    y, _ = tdec(tcfg, p, xt, state)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(proj)),
                                [getattr(p, n) for n in NAMES[kind]] + [xt])
    for name, g in zip(NAMES[kind], grads):
        near(g, ref_grad(name, jgp[name]), 1e-4, f"decode grad {name}")
    near(grads[-1], jgx, 1e-4, "decode grad x")
