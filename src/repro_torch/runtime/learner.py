"""Parallel learners — port of ``repro.runtime.learner``: the paper's
parameter-server adaptation (§V-B) over a mesh of ranks.

Each rank runs one learner on its own replay shard and the gradients are
averaged across the mesh before the optimizer step, so the replicated
agent state stays identical on every rank.  The reduce takes four forms
(``make_grad_reducer``):

  * plain: a mean over every mesh axis (one fused all-reduce per axis);
  * bounded staleness (``max_staleness``): each shard's gradient is scaled
    by ``staleness_weights(age)`` and the sum renormalized by the global
    weight total, so the realized weights sum to one while any shard is
    within the bound and the update is exactly zero when none is;
  * hierarchical (``compress_axis``, the 2-D ``(pod, data)`` mesh): a mean
    over the fast intra-pod axis, then the int8 error-feedback
    ``compressed_pmean`` across pods, with the EF buffer threaded through
    ``LoopState.ef_error`` (identical on the data shards of a pod, which
    compress the same partial; different across pods);
  * overlapped (``overlap=True`` on top of ``compress_axis``): learn event
    *i* applies ``pm_{i−1} + (p_i − p_{i−1})``, so the cross-pod mean
    issued at event *i* is first consumed at event *i+1*.

``intra_pod_dtype="bf16"`` casts the fast-axis leg to bf16 on the wire;
the error it injects is the ``compress_error_norm`` metric.  Gradients are
lists of tensors (``Agent.grads``); the rank's ``age`` is a host int.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.agents.base import Agent
from repro_torch.core.distributed import ShardedPrioritizedReplay
from repro_torch.optim import compress
from repro_torch.optim.collectives import all_reduce_axes, fused_tree_reduce

Leaves = List[torch.Tensor]


def pmean_gradients(grads: Sequence[torch.Tensor], axes: Tuple[str, ...], mesh,
                    dtype: Optional[torch.dtype] = None) -> Leaves:
    """Shard-average the gradient list (sum / axis size per axis).  The mean
    keeps the effective learning rate independent of the shard count.
    ``dtype`` (e.g. ``torch.bfloat16``) casts each leaf onto the wire
    before the reduce and back after.  One fused collective per axis."""
    grads = list(grads)
    cast = dtype is not None and bool(axes)   # no axes → nothing on a wire
    wire = [g.to(dtype) for g in grads] if cast else grads
    red = fused_tree_reduce(wire, axes, mesh, op="mean")
    if cast:
        red = [o.to(g.dtype) for o, g in zip(red, grads)]
    return list(red)


def _pmean_inexact(tensors: Sequence[torch.Tensor], axes: Tuple[str, ...], mesh) -> Leaves:
    """Mean of the floating tensors only (integer step counters stay)."""
    return list(fused_tree_reduce(list(tensors), axes, mesh, op="mean",
                                  select=lambda x: x.is_floating_point()))


def _weighted_psum(tensors: Sequence[torch.Tensor], scale: torch.Tensor,
                   axes: Tuple[str, ...], mesh, dtype: Optional[torch.dtype] = None) -> Leaves:
    """Sum over ``axes`` of ``leaf * scale`` (``scale`` a per-shard scalar);
    ``dtype`` casts onto the wire as ``pmean_gradients`` does."""
    tensors = list(tensors)
    cast = dtype is not None and bool(axes)
    scaled = [x * scale for x in tensors]
    if cast:
        scaled = [x.to(dtype) for x in scaled]
    red = fused_tree_reduce(scaled, axes, mesh, op="sum")
    if cast:
        red = [o.to(x.dtype) for o, x in zip(red, tensors)]
    return list(red)


def _renormalize(w: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """``w / Σw`` with the all-stale clamp."""
    return w / torch.clamp(total, min=1e-12)


def resolve_reduce_dtype(intra_pod_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The executor's intra-pod reduce dtype option → a torch dtype (None =
    f32, no cast)."""
    if intra_pod_dtype in (None, "f32", "float32"):
        return None
    if intra_pod_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(
        f"intra_pod_dtype={intra_pod_dtype!r}: expected 'f32' or 'bf16'")


def staleness_weights(ages: torch.Tensor, max_staleness: int) -> torch.Tensor:
    """Bounded-staleness discount: weight 1/(1+age), 0 beyond the bound
    (a dropped straggler)."""
    w = 1.0 / (1.0 + ages.to(torch.float32))
    return torch.where(ages > max_staleness, torch.zeros_like(w), w)


def staleness_reduce_weights(ages: torch.Tensor, max_staleness: int) -> torch.Tensor:
    """The realized per-shard weights of the bounded-staleness reduce:
    ``staleness_weights`` renormalized by their sum over the shard vector.
    They sum to 1 whenever a shard is within the bound, to 0 otherwise."""
    w = staleness_weights(ages, max_staleness)
    return _renormalize(w, torch.sum(w))


def make_grad_reducer(axes: Tuple[str, ...], mesh=None, max_staleness: Optional[int] = None,
                      compress_axis: Optional[str] = None,
                      intra_pod_dtype: Optional[str] = None, overlap: bool = False):
    """The cross-shard gradient reduce of ``make_sharded_learn``:
    ``reduce_grads(grads, age, ef) → (reduced, ef')`` over the ``axes`` of
    ``mesh`` (module docstring for the four forms).

    The overlapped update is computed as ``pm_{i−1} + (p_i − p_{i−1})``:
    on a constant gradient stream the delta is exactly 0.0, so event *i*
    applies the barrier reduce's event-*i−1* output bit for bit; on a
    varying stream the cumulative difference telescopes to ``p_T − pm_T``.
    Incompatible with ``max_staleness``, whose global renormalization
    would put this event's cross-pod traffic back on the critical path."""
    if compress_axis is not None and compress_axis not in axes:
        raise ValueError(
            f"compress_axis={compress_axis!r} is not one of the mesh "
            f"axes {axes}")
    if overlap and compress_axis is None:
        raise ValueError(
            "overlap=True needs compress_axis: the double buffer defers "
            "the compressed cross-pod leg — with no pod leg there is "
            "nothing to overlap (the intra-pod pmean stays synchronous)")
    if overlap and max_staleness is not None:
        raise ValueError(
            "overlap=True is incompatible with max_staleness: the "
            "bounded-staleness reduce renormalizes by a global weight "
            "total, which puts this event's cross-pod traffic back on "
            "the critical path — pick one of the two staleness forms")
    fast_axes = tuple(ax for ax in axes if ax != compress_axis)
    wire_dtype = resolve_reduce_dtype(intra_pod_dtype)

    def reduce_grads(grads, age, ef):
        if compress_axis is not None and not ef:
            raise ValueError(
                "compress_axis is set but no error-feedback buffer was "
                "passed: thread LoopState.ef_error through the learn fn "
                "(init_loop_state(..., ef_buffer=True) materializes it)")
        grads = list(grads)
        if overlap:
            # pm + (p − p'), not p + (pm − p'): for an unchanged partial the
            # delta is exactly 0.0 and the update is the previous output
            partial = pmean_gradients(grads, fast_axes, mesh, dtype=wire_dtype)
            pod_mean, new_ef = compress.compressed_pmean(partial, ef["ef"],
                                                         compress_axis, mesh)
            applied = [pm + (p - pp) for pm, p, pp in
                       zip(ef["prev_mean"], partial, ef["prev_partial"])]
            return applied, {"ef": new_ef, "prev_mean": pod_mean,
                             "prev_partial": partial}
        if max_staleness is None or age is None:
            if compress_axis is None:
                return pmean_gradients(grads, axes, mesh, dtype=wire_dtype), ef
            # hierarchical: the mean inside the pod, the int8-EF mean across
            partial = pmean_gradients(grads, fast_axes, mesh, dtype=wire_dtype)
            return compress.compressed_pmean(partial, ef, compress_axis, mesh)
        device = grads[0].device
        w = staleness_weights(torch.full((), age, dtype=torch.int32, device=device),
                              max_staleness)
        total = all_reduce_axes(w.clone(), axes, mesh, "sum")
        # realized weight of shard d is w_d / Σw: 1 in all while any shard
        # is within the bound, an all-zero gradient (params held) otherwise
        wn = _renormalize(w, total)
        if compress_axis is None:
            return _weighted_psum(grads, wn, axes, mesh, dtype=wire_dtype), ef
        # weighted partial sums inside the pod, then the compressed mean
        # across pods times the pod count (= the cross-pod sum).  An
        # all-stale round gives an exactly zero update with the EF buffer
        # held: the quantizer would fold the carried error into the zero
        # partials and emit ≈ Σ_pods ef_p without the gate.
        partial = _weighted_psum(grads, wn, fast_axes, mesh, dtype=wire_dtype)
        pod_mean, new_ef = compress.compressed_pmean(partial, ef, compress_axis, mesh)
        n_pods = mesh.axis_size(compress_axis)
        alive = total > 0
        reduced = [torch.where(alive, g * n_pods, torch.zeros_like(g)) for g in pod_mean]
        ef = [torch.where(alive, n, o) for n, o in zip(new_ef, ef)]
        return reduced, ef

    return reduce_grads


def make_sharded_learn(agent: Agent, replay: ShardedPrioritizedReplay, batch_per_shard: int,
                       mesh, beta: float = 0.4, max_staleness: Optional[int] = None,
                       compress_axis: Optional[str] = None,
                       intra_pod_dtype: Optional[str] = None, lazy_writes: bool = False,
                       overlap: bool = False):
    """This rank's learner call: local PER sample → local gradients →
    reduce over the mesh → update.  Returns ``sharded_learn(agent_state,
    replay_state, generator, age=None, ef=None, u=None) → (agent_state',
    replay_state', learn_metrics, ef')``, the signature of the fused
    ``loop.make_learner_step`` (``u`` overrides the uniform draws):

      * the sample is local, its weights global (``ShardedPrioritizedReplay
        .sample``);
      * agents with the ``grads``/``apply_grads`` split (DQN) reduce the
        gradients before the optimizer step, so the replicated state stays
        bit-identical across ranks;
      * agents without it (DDPG, TD3, SAC) fall back to a local ``learn``
        followed by a mean of the params, target and Adam moments over the
        mesh (exact at one shard, approximate beyond), which refuses
        ``compress_axis`` and ``intra_pod_dtype`` (no gradient to quantize
        or cast);
      * ``learn_metrics["compress_error_norm"]`` is the local bf16 cast
        error ‖g − bf16(g)‖₂ where the fast leg casts, plus the EF
        buffer's norm where the pod leg compresses (only the quantizer's
        ``"ef"`` in overlap mode), else 0.0;
      * the priority write-back is local (``lazy_writes`` defers its
        propagation to the loop's flush).
    """
    axes = replay.config.axis_names
    split = agent.grads is not None and agent.apply_grads is not None
    if compress_axis is not None and not split:
        raise ValueError(
            f"agent {agent.name!r} has no grads/apply_grads split: the "
            "compressed cross-pod reduce needs the explicit gradient "
            "pytree (the parameter-average fallback has nothing to "
            "quantize)")
    wire_dtype = resolve_reduce_dtype(intra_pod_dtype)
    if wire_dtype is not None and not split:
        raise ValueError(
            f"agent {agent.name!r} has no grads/apply_grads split: the "
            "bf16 intra-pod reduce needs the explicit gradient pytree "
            "(the parameter-average fallback has nothing to cast)")
    # the cast happens only where a fast-axis reduce exists
    fast_axes = tuple(ax for ax in axes if ax != compress_axis)
    cast_active = wire_dtype is not None and bool(fast_axes)
    reduce_grads = make_grad_reducer(axes, mesh, max_staleness=max_staleness,
                                     compress_axis=compress_axis,
                                     intra_pod_dtype=intra_pod_dtype, overlap=overlap)

    def sharded_learn(agent_state, replay_state, generator, age=None, ef=None, u=None):
        idx, items, is_w = replay.sample(replay_state, generator, batch_per_shard, beta,
                                         mesh=mesh, u=u)
        err_norm = 0.0
        if split:
            grads, aux = agent.grads(agent_state, items, is_w)
            if cast_active:
                err_norm = err_norm + compress.l2_norm(
                    [g - g.to(wire_dtype).to(g.dtype) for g in grads])
            grads, ef = reduce_grads(grads, age, ef)
            if ef:
                err_norm = err_norm + compress.l2_norm(ef["ef"] if overlap else ef)
            agent_state, metrics, td = agent.apply_grads(agent_state, grads, aux)
        else:
            agent_state, metrics, td = agent.learn(agent_state, items, is_w)
            shared = (list(agent_state.params.parameters())
                      + list(agent_state.target.parameters())
                      + agent_state.opt.m + agent_state.opt.v)
            with torch.no_grad():
                torch._foreach_copy_(shared, _pmean_inexact(shared, axes, mesh))
        replay_state = replay.update_priorities(replay_state, idx, td, lazy=lazy_writes)
        return (agent_state, replay_state,
                {"loss": metrics["loss"], "compress_error_norm": err_norm}, ef)

    return sharded_learn
