"""The port's collectives (repro_torch.optim.collectives, optim.compress,
runtime.learner's reduces) against the JAX functions on the same numpy
inputs.

The port's side runs on four gloo ranks, a 2×2 (pod, data) mesh spawned
through launch/mesh.py::spawn once for the module; the reference's runs
here, its collectives under nested ``jax.vmap(..., axis_name=...)``.  The
rank function lives in this module and the spawned ranks import it, so
JAX is imported inside the tests, never at the top.

Tolerances:
  * pure functions exactly: compress/decompress (q, scale, error),
    staleness_weights, _renormalize, payload_bytes, raw_bytes;
    staleness_reduce_weights at rtol 1e-6, since it divides by a sum that
    the two sides add in different orders;
  * a collective's result against the reference's: rtol 1e-6 / atol 1e-7
    in f32 (the two sum in different orders); int8 ``q`` of a reduced
    partial within 1;
  * the port's own equivalences bit for bit: the fused reduce against the
    per-leaf one (two ranks an axis: a sum of two commutes exactly), the
    overlapped reduce on a constant stream against the barrier reduce one
    event earlier, the all-stale round's zero update and held EF buffer.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as meshlib
from repro_torch.optim import collectives, compress
from repro_torch.runtime import learner

RTOL, ATOL = 1e-6, 1e-7


def _inputs(seed=7):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(2, 2, 3, 5)).astype(np.float32),
        "b": rng.normal(size=(2, 2, 7)).astype(np.float32),
        "h": rng.normal(size=(2, 2, 4)).astype(np.float16),
        "step": rng.integers(0, 9, size=(2, 2)).astype(np.int32),
        "g": (rng.normal(size=(2, 2, 8, 8)) * 1e-2).astype(np.float32),
        "g1": rng.normal(size=(2, 2, 8, 8)).astype(np.float32),
        "ef": (rng.normal(size=(2, 2, 8, 8)) * 1e-3).astype(np.float32),
        "stream": (rng.normal(size=(8, 2, 2, 8, 8)) * 1e-2).astype(np.float32),
    }


AGES = {"staleness": np.array([[0, 1], [2, 3]], np.int32),
        "all_stale": np.full((2, 2), 7, np.int32),
        "one_alive": np.array([[0, 7], [7, 7]], np.int32)}


def _collectives_rank(rank, path):
    """On each of the four ranks: every collective of the module on this
    cell's slice of the inputs saved at ``path`` → numpy results."""
    torch.set_num_threads(1)
    with np.load(path) as f:
        inputs = dict(f)
    mesh = meshlib.pod_data_mesh(2, 2)
    p, d = mesh.axis_index("pod"), mesh.axis_index("data")
    cell = {k: torch.from_numpy(np.array(v[p, d])) for k, v in inputs.items() if k != "stream"}
    axes = ("pod", "data")
    tree = {k: cell[k] for k in ("w", "b", "h", "step")}
    out = {}
    for op in ("mean", "sum", "max"):
        fused = collectives.fused_tree_reduce(tree, axes, mesh, op)
        per_leaf = {k: collectives.all_reduce_axes(v.clone(), axes, mesh, op)
                    for k, v in tree.items()}
        for k in tree:
            out[f"{op}/fused/{k}"] = fused[k].numpy()
            out[f"{op}/leaf/{k}"] = per_leaf[k].numpy()
    sel = collectives.fused_tree_reduce(tree, axes, mesh, "mean",
                                        select=lambda x: x.is_floating_point())
    out["select/step"] = sel["step"].numpy()
    out["select/w"] = sel["w"].numpy()
    out["untouched/w"] = tree["w"].numpy()
    g, g1, ef = [cell["g"]], [cell["g1"]], [cell["ef"]]
    zero = compress.init_error(g)
    red, err = compress.compressed_pmean(g, zero, "pod", mesh)
    out["cpmean/red"], out["cpmean/err"] = red[0].numpy(), err[0].numpy()
    partial = learner.pmean_gradients(g, ("data",), mesh)
    out["partial_q"] = compress.compress(partial, zero)[0][0].q.numpy()

    def reduce(name, grads, age, ef_in, **kw):
        r, e = learner.make_grad_reducer(axes, mesh, **kw)(grads, age, ef_in)
        out[f"{name}/red"] = r[0].numpy()
        if e:
            out[f"{name}/ef"] = e[0].numpy()

    reduce("plain", g, None, None)
    reduce("hier", g, None, zero, compress_axis="pod")
    reduce("stale", g, int(AGES["staleness"][p, d]), None, max_staleness=2)
    reduce("stale_hier", g, int(AGES["staleness"][p, d]), ef, max_staleness=2,
           compress_axis="pod")
    reduce("all_stale", g1, int(AGES["all_stale"][p, d]), ef, max_staleness=1,
           compress_axis="pod")
    reduce("one_alive", g1, int(AGES["one_alive"][p, d]), ef, max_staleness=1,
           compress_axis="pod")
    reduce("bf16", g, None, None, intra_pod_dtype="bf16")
    reduce("bf16_hier", g, None, zero, compress_axis="pod", intra_pod_dtype="bf16")
    # EF through the real collective: 50 events of a growing gradient over
    # the pod axis, with the carried error and without
    base = [cell["g"]]
    err = compress.init_error(base)
    tot_deq, tot_no_ef = torch.zeros(8, 8), torch.zeros(8, 8)
    for i in range(50):
        gi = [base[0] * (1 + 0.02 * i)]
        red, err = compress.compressed_pmean(gi, err, "pod", mesh)
        tot_deq += red[0]
        tot_no_ef += compress.compressed_pmean(gi, compress.init_error(gi), "pod", mesh)[0][0]
    out["ef_stream/deq"], out["ef_stream/no_ef"] = tot_deq.numpy(), tot_no_ef.numpy()
    # the pod leg alone, each data column its own stream: the barrier and the
    # overlapped reduce on a constant and on a varying stream
    barrier = learner.make_grad_reducer(("pod",), mesh, compress_axis="pod")
    overlap = learner.make_grad_reducer(("pod",), mesh, compress_axis="pod", overlap=True)
    for name, stream in (("const", [inputs["stream"][0, p, d]] * 6),
                         ("vary", list(inputs["stream"][:, p, d]))):
        e_b = compress.init_error([torch.zeros(8, 8)])
        e_o = {k: compress.init_error([torch.zeros(8, 8)])
               for k in ("ef", "prev_mean", "prev_partial")}
        for t, x in enumerate(stream):
            gt = [torch.from_numpy(x.copy())]
            rb, e_b = barrier(gt, None, e_b)
            ro, e_o = overlap(gt, None, e_o)
            out[f"{name}/barrier/{t}"], out[f"{name}/overlap/{t}"] = rb[0].numpy(), ro[0].numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    path = tmp_path_factory.mktemp("collectives") / "inputs.npz"
    np.savez(path, **inputs)
    return inputs, meshlib.spawn(_collectives_rank, 4, str(path), backend="gloo",
                                 device="cpu", timeout_s=300)


def _cells(results, key):
    """(2, 2, ...) stack of one result over the mesh cells (rank = 2p + d)."""
    return np.stack([r[key] for r in results]).reshape((2, 2) + results[0][key].shape)


def _jax_pod_data(fn, *args):
    import jax
    return jax.vmap(jax.vmap(fn, axis_name="data"), axis_name="pod")(*args)


# -- pure functions, exactly ----------------------------------------------------


def test_compress_decompress_match_reference_exactly():
    import jax.numpy as jnp

    from repro.optim import compress as jc
    rng = np.random.default_rng(0)
    for scale in (1e-4, 1e-2, 1.0, 30.0):
        g = (rng.normal(size=(64, 33)) * scale).astype(np.float32)
        e = (rng.normal(size=(64, 33)) * 1e-3 * scale).astype(np.float32)
        jcomp, jerr = jc.compress({"w": jnp.asarray(g)}, {"w": jnp.asarray(e)})
        tcomp, terr = compress.compress([torch.from_numpy(g.copy())],
                                        [torch.from_numpy(e.copy())])
        assert tcomp[0].q.dtype == torch.int8
        np.testing.assert_array_equal(tcomp[0].q.numpy(), np.asarray(jcomp["w"].q))
        assert float(tcomp[0].scale) == float(jcomp["w"].scale)
        np.testing.assert_array_equal(terr[0].numpy(), np.asarray(jerr["w"]))
        np.testing.assert_array_equal(compress.decompress(tcomp)[0].numpy(),
                                      np.asarray(jc.decompress(jcomp)["w"]))


def test_payload_and_raw_bytes_match_reference():
    import jax.numpy as jnp

    from repro.optim import compress as jc
    shapes = [(1024,), (16, 8), (3,)]
    jtree = {f"l{i}": jnp.zeros(s, jnp.float32) for i, s in enumerate(shapes)}
    leaves = [torch.zeros(s) for s in shapes]
    jcomp, _ = jc.compress(jtree, jc.init_error(jtree))
    tcomp, _ = compress.compress(leaves, compress.init_error(leaves))
    assert compress.payload_bytes(tcomp) == jc.payload_bytes(jcomp) == 1024 + 128 + 3 + 12
    assert compress.raw_bytes(leaves) == jc.raw_bytes(jtree) == 4 * (1024 + 128 + 3)
    assert compress.payload_bytes(tcomp) * 3.9 < compress.raw_bytes(leaves)


def test_compress_refuses_mismatched_error_buffer():
    with pytest.raises(ValueError, match="error-feedback buffer has 1 leaves"):
        compress.compress([torch.zeros(3), torch.zeros(2)], [torch.zeros(3)])


def test_l2_norm_matches_reference():
    import jax.numpy as jnp

    from repro.optim import compress as jc
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (11,))]
    want = float(jc.l2_norm({str(i): jnp.asarray(x) for i, x in enumerate(xs)}))
    got = float(compress.l2_norm([torch.from_numpy(x) for x in xs]))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert float(compress.l2_norm([])) == 0.0


def test_int8_ef_compression_contracts():
    """tests/test_distributed.py's EF-SGD property on the port: with error
    feedback the cumulative dequantized stream tracks the true one, and
    better than without."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32) * 1e-2)
    err = compress.init_error([g])
    true, deq, no_ef = (torch.zeros(64, 64) for _ in range(3))
    for i in range(50):
        gi = g * (1 + 0.01 * i)
        comp, err = compress.compress([gi], err)
        true += gi
        deq += compress.decompress(comp)[0]
        no_ef += compress.decompress(compress.compress([gi], compress.init_error([g]))[0])[0]
    rel = float(torch.linalg.norm(deq - true) / torch.linalg.norm(true))
    rel_no_ef = float(torch.linalg.norm(no_ef - true) / torch.linalg.norm(true))
    assert rel < 2e-3 and rel < rel_no_ef, (rel, rel_no_ef)


def test_staleness_weights_match_reference_exactly():
    import jax.numpy as jnp

    from repro.runtime import learner as jl
    rng = np.random.default_rng(0)
    for _ in range(200):
        ages = rng.integers(0, 65, size=int(rng.integers(1, 17))).astype(np.int32)
        bound = int(rng.integers(0, 17))
        t = torch.from_numpy(ages)
        np.testing.assert_array_equal(learner.staleness_weights(t, bound).numpy(),
                                      np.asarray(jl.staleness_weights(jnp.asarray(ages), bound)))
        # the renormalization divides by a sum, which the two sides add in
        # different orders: held to rtol 1e-6
        np.testing.assert_allclose(
            learner.staleness_reduce_weights(t, bound).numpy(),
            np.asarray(jl.staleness_reduce_weights(jnp.asarray(ages), bound)), rtol=RTOL)
    w = learner.staleness_weights(torch.tensor([0, 1, 3, 10]), 4)
    assert w[0] == 1.0 and w[1] == 0.5 and w[3] == 0.0
    w, tot = np.float32([0.5, 0.25]), np.float32(0.0)
    np.testing.assert_array_equal(
        learner._renormalize(torch.from_numpy(w), torch.tensor(tot)).numpy(),
        np.asarray(jl._renormalize(jnp.asarray(w), jnp.asarray(tot))))


def test_staleness_renormalization_preserves_gradient_scale():
    """tests/test_async_executor.py's seeded sweep: the realized weights sum
    to 1 while any shard is within the bound, stragglers get exactly 0,
    an all-stale round sums to 0; fresher shards never weigh less."""
    rng = np.random.default_rng(0)
    cases = [(rng.integers(0, 65, size=int(rng.integers(1, 17))), int(rng.integers(0, 17)))
             for _ in range(300)]
    cases += [(np.zeros(4, np.int64), 0), (np.array([0, 5, 5, 5]), 1), (np.array([3, 4, 5]), 2)]
    for ages, bound in cases:
        w = learner.staleness_reduce_weights(torch.from_numpy(ages), bound).numpy()
        alive = ages <= bound
        assert (w >= 0).all()
        if alive.any():
            np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
            assert (w[~alive] == 0).all()
        else:
            assert w.sum() == 0.0
    for _ in range(50):
        ages = rng.integers(0, 9, size=int(rng.integers(2, 9)))
        w = learner.staleness_weights(torch.from_numpy(ages), 8).numpy()
        assert (np.diff(w[np.argsort(ages)]) <= 1e-7).all()


def test_reduce_validation_matches_reference():
    with pytest.raises(ValueError, match="intra_pod_dtype"):
        learner.resolve_reduce_dtype("fp8")
    assert learner.resolve_reduce_dtype("bf16") is torch.bfloat16
    assert learner.resolve_reduce_dtype("f32") is None
    with pytest.raises(ValueError, match="axes"):
        learner.make_grad_reducer(("data",), compress_axis="pod")
    with pytest.raises(ValueError, match="overlap"):
        learner.make_grad_reducer(("data",), overlap=True)
    with pytest.raises(ValueError, match="max_staleness"):
        learner.make_grad_reducer(("pod",), compress_axis="pod", overlap=True, max_staleness=2)
    reducer = learner.make_grad_reducer(("pod", "data"), compress_axis="pod")
    with pytest.raises(ValueError, match="error-feedback"):
        reducer([torch.zeros(4)], None, None)


def test_fused_tree_reduce_without_axes_is_identity():
    tree = {"p": torch.ones(2, 4), "n": torch.arange(2, dtype=torch.int32)}
    mesh = meshlib.Mesh(("data",), (2,))
    assert collectives.fused_tree_reduce(tree, (), mesh) is tree
    assert collectives.fused_tree_reduce({}, ("data",), mesh) == {}
    with pytest.raises(ValueError, match="no process group"):
        collectives.fused_tree_reduce(tree, ("data",), mesh)
    with pytest.raises(ValueError, match="op="):
        collectives.all_reduce_axes(torch.ones(2), ("data",), mesh, "avg")


# -- collectives over four gloo ranks against the reference --------------------


def test_fused_reduce_is_the_per_leaf_reduce_bit_for_bit(ranks):
    _, res = ranks
    for op in ("mean", "sum", "max"):
        for k in ("w", "b", "h", "step"):
            for r in res:
                a, b = r[f"{op}/fused/{k}"], r[f"{op}/leaf/{k}"]
                assert a.dtype == b.dtype and np.array_equal(a, b), (op, k)


def test_fused_reduce_matches_reference(ranks):
    import jax
    import jax.numpy as jnp

    from repro.optim.collectives import fused_tree_reduce as jfused
    inputs, res = ranks
    tree = {k: jnp.asarray(inputs[k]) for k in ("w", "b", "h", "step")}
    for op, prim in (("mean", jax.lax.pmean), ("sum", jax.lax.psum), ("max", jax.lax.pmax)):
        want = _jax_pod_data(lambda t: jfused(t, ("pod", "data"), prim), tree)
        for k in tree:
            got = _cells(res, f"{op}/fused/{k}")
            ref = np.asarray(want[k])
            assert got.dtype == ref.dtype, (op, k, got.dtype, ref.dtype)
            tol = dict(rtol=1e-3, atol=1e-3) if k == "h" else dict(rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got, ref, **tol, err_msg=f"{op}/{k}")


def test_fused_reduce_select_passes_unselected_through(ranks):
    inputs, res = ranks
    for rank, r in enumerate(res):
        p, d = divmod(rank, 2)
        np.testing.assert_array_equal(r["select/step"], inputs["step"][p, d])
        np.testing.assert_array_equal(r["select/w"], r["mean/fused/w"])
        np.testing.assert_array_equal(r["untouched/w"], inputs["w"][p, d])


def test_compressed_pmean_matches_reference(ranks):
    import jax.numpy as jnp

    from repro.optim import compress as jc
    inputs, res = ranks
    g = jnp.asarray(inputs["g"])

    def one(gp):
        red, err = jc.compressed_pmean({"w": gp}, {"w": jnp.zeros_like(gp)}, "pod")
        return red["w"], err["w"]

    want_red, want_err = _jax_pod_data(one, g)
    np.testing.assert_allclose(_cells(res, "cpmean/red"), np.asarray(want_red),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_cells(res, "cpmean/err"), np.asarray(want_err),
                               rtol=RTOL, atol=ATOL)
    # the mean, not the sum: within quantization of the f32 pmean
    tol = 2 * float(np.abs(inputs["g"]).max()) / 127.0
    np.testing.assert_allclose(_cells(res, "cpmean/red")[0, 0],
                               inputs["g"][:, 0].mean(axis=0), atol=tol)


def test_compressed_pmean_ef_contraction_through_reduce(ranks):
    """tests/test_distributed.py's EF-SGD property through the collective:
    summed over a growing stream, the compressed means track the summed
    true means, better than without the carried error."""
    inputs, res = ranks
    g = inputs["g"]
    for rank, r in enumerate(res):
        d = rank % 2
        true = sum(g[:, d].mean(axis=0) * (1 + 0.02 * i) for i in range(50))
        rel = np.linalg.norm(r["ef_stream/deq"] - true) / np.linalg.norm(true)
        rel_no_ef = np.linalg.norm(r["ef_stream/no_ef"] - true) / np.linalg.norm(true)
        assert rel < 2e-3 and rel < rel_no_ef, (rel, rel_no_ef)


def test_reduced_partial_quantizes_as_the_reference(ranks):
    import jax
    import jax.numpy as jnp

    from repro.optim import compress as jc
    inputs, res = ranks

    def one(gp):
        part = jax.lax.pmean(gp, "data")
        comp, _ = jc.compress({"w": part}, {"w": jnp.zeros_like(part)})
        return comp["w"].q

    want = np.asarray(_jax_pod_data(one, jnp.asarray(inputs["g"]))).astype(np.int32)
    got = _cells(res, "partial_q").astype(np.int32)
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("name", ["plain", "hier", "stale", "stale_hier", "all_stale",
                                  "one_alive", "bf16", "bf16_hier"])
def test_grad_reducer_matches_reference(ranks, name):
    import jax.numpy as jnp

    from repro.runtime.learner import make_grad_reducer as jmake
    inputs, res = ranks
    kw = {"plain": {}, "hier": dict(compress_axis="pod"),
          "stale": dict(max_staleness=2), "stale_hier": dict(max_staleness=2, compress_axis="pod"),
          "all_stale": dict(max_staleness=1, compress_axis="pod"),
          "one_alive": dict(max_staleness=1, compress_axis="pod"),
          "bf16": dict(intra_pod_dtype="bf16"),
          "bf16_hier": dict(compress_axis="pod", intra_pod_dtype="bf16")}[name]
    grads = inputs["g1"] if name in ("all_stale", "one_alive") else inputs["g"]
    ef = (np.zeros_like(inputs["ef"]) if name in ("hier", "bf16_hier") else inputs["ef"])
    ages = AGES.get({"stale": "staleness", "stale_hier": "staleness"}.get(name, name),
                    np.zeros((2, 2), np.int32))
    reducer = jmake(("pod", "data"), **kw)

    def cell(g, age, e):
        red, e2 = reducer({"w": g}, age, {"w": e})
        return red["w"], e2["w"]

    want_red, want_ef = _jax_pod_data(cell, jnp.asarray(grads), jnp.asarray(ages), jnp.asarray(ef))
    np.testing.assert_allclose(_cells(res, f"{name}/red"), np.asarray(want_red),
                               rtol=RTOL, atol=ATOL)
    if "compress_axis" in kw:
        np.testing.assert_allclose(_cells(res, f"{name}/ef"), np.asarray(want_ef),
                                   rtol=RTOL, atol=ATOL)


def test_all_stale_compressed_round_zero_update_ef_held(ranks):
    inputs, res = ranks
    assert np.abs(_cells(res, "all_stale/red")).max() == 0.0
    np.testing.assert_array_equal(_cells(res, "all_stale/ef"), inputs["ef"])
    # one shard alive: the reduce is its gradient (weight 1) within
    # quantization, and the EF buffer moves again
    tol = 2 * float((np.abs(inputs["g1"]) + np.abs(inputs["ef"])).max()) / 127.0
    np.testing.assert_allclose(_cells(res, "one_alive/red")[0, 0], inputs["g1"][0, 0], atol=tol)
    assert not np.array_equal(_cells(res, "one_alive/ef"), inputs["ef"])


def test_hierarchical_and_bf16_reduces_track_the_f32_mean(ranks):
    inputs, res = ranks
    target = inputs["g"].mean(axis=(0, 1))
    q_tol = 2 * float(np.abs(inputs["g"]).max()) / 127.0
    bf_tol = float(np.abs(inputs["g"]).max()) / 128.0
    for name, tol in (("hier", q_tol), ("bf16", bf_tol), ("bf16_hier", q_tol + bf_tol)):
        red = _cells(res, f"{name}/red")
        assert red.dtype == np.float32
        for p in range(2):
            for d in range(2):
                np.testing.assert_allclose(red[p, d], target, atol=tol, err_msg=name)


def test_overlapped_reduce_shift_identity_on_constant_stream(ranks):
    _, res = ranks
    for r in res:
        for t in range(1, 6):
            np.testing.assert_array_equal(r[f"const/overlap/{t}"], r[f"const/barrier/{t - 1}"])


def test_overlapped_reduce_telescopes_and_matches_reference(ranks):
    import jax
    import jax.numpy as jnp

    from repro.runtime.learner import make_grad_reducer as jmake
    inputs, res = ranks
    stream = inputs["stream"]
    for rank, r in enumerate(res):
        p, d = divmod(rank, 2)
        cum = sum(r[f"vary/overlap/{t}"] - r[f"vary/barrier/{t}"] for t in range(8))
        np.testing.assert_allclose(cum, stream[-1, p, d] - r["vary/barrier/7"], atol=1e-6)
    # the reference's two reducers over the pod axis, column by column
    z = jnp.zeros((2, 8, 8))
    for d in range(2):
        for mode, reducer in (("barrier", jmake(("pod",), compress_axis="pod")),
                              ("overlap", jmake(("pod",), compress_axis="pod", overlap=True))):
            ef = {"w": z} if mode == "barrier" else {
                "ef": {"w": z}, "prev_mean": {"w": z}, "prev_partial": {"w": z}}
            for t in range(8):
                out, ef = jax.vmap(lambda g, e: reducer({"w": g}, None, e),
                                   axis_name="pod")(jnp.asarray(stream[t, :, d]), ef)
                got = np.stack([res[2 * p + d][f"vary/{mode}/{t}"] for p in range(2)])
                np.testing.assert_allclose(got, np.asarray(out["w"]), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{mode} event {t} column {d}")
