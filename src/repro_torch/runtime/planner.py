"""DSE-driven runtime configuration planner (paper §V-D, Eq. 5 — Fig. 12
generalized from 1-D lane splits to full runtime configs) — a copy of
``repro.runtime.planner``, which is pure Python: the port imports nothing
of the JAX package, so it keeps its own.  Only ``profile`` differs: the
reference's reuses its benchmark sweeps, the port's the same sweeps kept
beside it (``runtime/sweeps.py``), on the card unless asked for the CPU.

``dse.solve`` answers one question: how to split a scalar lane budget
between actors and learners so collection matches consumption (Eq. 5).
The runtime has three executor backends (fused | sharded | async), a
two-axis pod×data mesh of ranks and a ``publish_interval`` staleness
knob, so the planner searches the full configuration space

    (backend, n_pods, n_data, publish_interval, lane split)

from *measured* throughput, in the spirit of GA3C's dynamic adjustment
of actor/learner process counts (PAPERS.md):

  * profiled points come from ``BENCH_fig9.json`` (env-steps/s per
    executor backend and publish interval) and ``BENCH_fig10.json``
    (env-steps/s per shard/pod count), the json that the reference's
    ``benchmarks/run.py --emit-json`` writes — or live via
    :func:`profile`, which runs the same sweeps (``runtime/sweeps.py``);
  * the Eq. 5 lane split within the chosen config uses
    ``dse.solve`` on the actor/learner curves, hull-clamped
    (``dse.interp_hull``) so no allocation claims unmeasured throughput;
  * a config measured both emulated (devices time-sliced in one process)
    and wall-clock (the real multi-process gang points of the fig10
    ``--wall-clock`` arm, ``backend="wallclock"``) keeps only the
    wall-clock measurement;
  * candidates are scored by realized env-steps/s — a single unit across
    both json files — subject to feasibility: a config is only eligible
    if it was actually measured (the config-level "profiled hull"), its
    device/batch divisibility holds, and for async configs the
    publish/learn-period aliasing rule of ``AsyncExecutor`` admits it (a
    ``publish_interval`` sharing a factor with the learn period greater
    than ``max_staleness + 1`` would permanently drop shards from the
    gradient reduce — the executor would refuse to construct, so the
    planner never selects it);
  * the winner is emitted as an executable :class:`PlannedConfig` that
    ``runtime.executors.executor_from_plan`` / ``launch.mesh.
    mesh_from_plan`` instantiate directly, and that
    ``python -m repro_torch.quickstart --plan BENCH_plan.json`` and
    ``launch/train.py --plan`` consume from disk.

This module imports neither torch nor the executors: a plan can be
loaded and inspected before any rank is started.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.runtime import dse

BACKENDS = ("fused", "sharded", "async")

FIG9_JSON = "BENCH_fig9.json"
FIG10_JSON = "BENCH_fig10.json"
SERVE_JSON = "BENCH_serve.json"
PLAN_JSON = "BENCH_plan.json"


# -- the executable plan -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlannedConfig:
    """A full runtime configuration the planner chose — everything an
    executor constructor needs, in one serializable record.

    ``backend`` selects the executor class; ``n_pods``/``n_data`` the
    mesh (``n_data=0`` means no mesh: the fused program, also for the
    fused-async path); ``publish_interval``/``max_staleness`` the async
    knobs (0/0 on the synchronous backends); ``x_actor``/``x_learner``
    the Eq. 5 lane split (0 when no curves were provided), with
    ``n_envs`` the actor lanes rounded up to a multiple of the shard
    count so the executor's divisibility checks hold.

    ``n_replay_shards``/``samples_per_insert`` are the replay-service
    degrees of freedom (DESIGN.md §11): 0/0.0 keeps the replay in-loop
    (the fused/sharded/async programs above); ``n_replay_shards ≥ 1``
    routes experience through a ``ReplayService`` with that many shards
    behind a ``RateLimiter`` pinned to ``samples_per_insert`` — the
    explicit flow-control form of ``update_interval``'s implicit ratio
    (spi = batch_size / update_interval).
    """

    backend: str
    n_pods: int = 1
    n_data: int = 0                    # 0 = no mesh (fused program)
    publish_interval: int = 0          # 0 = synchronous
    max_staleness: int = 0
    compress_pod_reduce: bool = False
    overlap_pod_reduce: bool = False   # double-buffered compressed pod leg
    n_envs: int = 8
    update_interval: int = 1
    x_actor: int = 0                   # Eq. 5 lanes; 0 = not lane-solved
    x_learner: int = 0
    n_replay_shards: int = 0           # 0 = in-loop replay (no service)
    samples_per_insert: float = 0.0    # 0 = implicit (update_interval)
    predicted_env_steps_per_s: float = 0.0
    source: str = "unspecified"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r}: "
                             f"expected one of {BACKENDS}")
        if self.backend == "async" and self.publish_interval < 1:
            raise ValueError("async plan needs publish_interval ≥ 1")
        if self.backend != "async" and self.publish_interval:
            raise ValueError(f"backend={self.backend!r} is synchronous — "
                             "publish_interval must be 0")
        if self.backend == "sharded" and self.n_data < 1:
            raise ValueError("sharded plan needs n_data ≥ 1 (a mesh)")
        if self.backend == "fused" and self.n_data:
            raise ValueError("fused plan must have n_data=0 (no mesh)")
        if self.compress_pod_reduce and self.n_pods < 2:
            raise ValueError("compress_pod_reduce needs n_pods ≥ 2 (the "
                             "compressed leg crosses the pod axis)")
        if self.overlap_pod_reduce and not self.compress_pod_reduce:
            raise ValueError("overlap_pod_reduce needs compress_pod_reduce "
                             "(the double buffer defers the compressed "
                             "cross-pod leg — runtime/learner.py)")
        if self.n_shards > 1 and self.n_envs % self.n_shards:
            raise ValueError(f"n_envs={self.n_envs} not divisible by "
                             f"{self.n_shards} shards")
        if self.n_replay_shards < 0:
            raise ValueError("n_replay_shards must be ≥ 0 (0 = in-loop "
                             "replay, no service)")
        if self.samples_per_insert < 0:
            raise ValueError("samples_per_insert must be ≥ 0 (0 = no "
                             "rate limit)")
        if self.samples_per_insert and not self.n_replay_shards:
            raise ValueError("samples_per_insert needs a replay service "
                             "(n_replay_shards ≥ 1) to enforce it")

    @property
    def n_shards(self) -> int:
        """Mesh cells (1 when the plan runs the fused program)."""
        return max(1, self.n_pods) * max(1, self.n_data)

    @property
    def n_devices(self) -> int:
        """Ranks the plan needs (one a mesh cell; 1 without a mesh)."""
        return self.n_shards if self.n_data else 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PlannedConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown PlannedConfig fields: {sorted(unknown)}")
        return cls(**d)

    def describe(self) -> str:
        mesh = ("no mesh" if not self.n_data
                else f"{self.n_pods}×{self.n_data} pod×data mesh"
                if self.n_pods > 1 else f"{self.n_data}-shard data mesh")
        knobs = (f", publish every {self.publish_interval}, "
                 f"max staleness {self.max_staleness}"
                 if self.backend == "async" else "")
        comp = ", int8-EF cross-pod reduce" if self.compress_pod_reduce else ""
        if self.overlap_pod_reduce:
            comp += " (overlapped)"
        if self.n_replay_shards:
            comp += (f", replay service ({self.n_replay_shards} shard"
                     f"{'s' if self.n_replay_shards > 1 else ''}, "
                     f"spi {self.samples_per_insert:g})")
        return (f"{self.backend} executor ({mesh}{knobs}{comp}), "
                f"{self.n_envs} envs, update_interval "
                f"{self.update_interval}, predicted "
                f"{self.predicted_env_steps_per_s:,.0f} env-steps/s "
                f"[{self.source}]")


# -- profiled candidates -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One measured runtime configuration (a point of the config-level
    profiled hull — the planner only ever selects measured configs).

    ``wallclock`` marks a point measured on a real multi-process gang
    (launch/multiprocess.py) rather than emulated host devices in one
    process; ``update_interval`` is the ratio the point was measured at
    (``None`` = the sweep default, matching any requested ratio —
    legacy emulated points don't carry the field)."""

    backend: str
    n_pods: int
    n_data: int
    publish_interval: int
    compress: bool
    n_envs: int
    env_steps_per_s: float
    source: str
    overlap: bool = False
    wallclock: bool = False
    update_interval: Optional[int] = None

    @property
    def config_key(self) -> Tuple:
        """The runtime configuration a point measured — everything but
        the measurement itself and how it was measured.  Two points with
        one config_key are the same config measured two ways (emulated
        vs wall-clock), and the planner keeps the wall-clock one."""
        return (self.backend, self.n_pods, self.n_data,
                self.publish_interval, self.compress, self.overlap,
                self.n_envs, self.update_interval)


def candidates_from_points(fig9_points: Iterable[dict] = (),
                           fig10_points: Iterable[dict] = (),
                           default_n_envs: int = 16) -> List[Candidate]:
    """Adapt BENCH json points to planner candidates.

    fig9 points carry the backend axis (fused + async publish-interval
    sweep, unsharded); fig10 points carry the shard/pod axis (sharded
    1-D counts and pod×data cells, with and without the compressed
    reduce).  Unknown backends are skipped, not errors — the json may
    come from a newer benchmark sweep.
    """
    out: List[Candidate] = []
    for p in fig9_points:
        backend = p.get("backend")
        shards = int(p.get("shards", 0))
        if backend == "fused":
            out.append(Candidate("fused", 1, 0, 0, False,
                                 int(p.get("n_envs", default_n_envs)),
                                 float(p["env_steps_per_s"]), "fig9"))
        elif backend == "async":
            out.append(Candidate("async", max(1, int(p.get("pods", 1))),
                                 shards, int(p["publish_interval"]), False,
                                 int(p.get("n_envs", default_n_envs)),
                                 float(p["env_steps_per_s"]), "fig9"))
    for p in fig10_points:
        backend = p.get("backend")
        if backend == "sharded":
            out.append(Candidate("sharded", 1, int(p["shards"]), 0, False,
                                 int(p.get("n_envs", default_n_envs)),
                                 float(p["env_steps_per_s"]), "fig10"))
        elif backend == "sharded_pod_data":
            out.append(Candidate("sharded", int(p["pods"]), int(p["shards"]),
                                 0, bool(p.get("compressed", False)),
                                 int(p.get("n_envs", default_n_envs)),
                                 float(p["env_steps_per_s"]), "fig10"))
        elif backend == "wallclock":
            # real multi-process gang measurement (fig10 --wall-clock
            # arm): the executable config drops the process count — a
            # launch-time detail — but keeps the reduce shape, and the
            # measured update_interval rides along so the ratio filter
            # in `feasible` never scores it against a different workload
            pods = max(1, int(p.get("pods", 1)))
            shards = int(p.get("shards", 1))
            fused = pods == 1 and shards <= 1
            publish = int(p.get("publish_interval", 0))
            backend_name = ("async" if publish
                            else "fused" if fused else "sharded")
            out.append(Candidate(
                backend_name, pods,
                0 if fused else shards,
                publish,
                bool(p.get("compressed", False)),
                int(p.get("n_envs", default_n_envs)),
                float(p["env_steps_per_s"]), "fig10-wallclock",
                overlap=bool(p.get("overlapped", False)),
                wallclock=True,
                update_interval=(int(p["update_interval"])
                                 if "update_interval" in p else None)))
    return out


# -- feasibility -------------------------------------------------------------


def learn_period(update_interval: int, env_steps_per_iter: int) -> int:
    """Iterations between learn events — the same arithmetic as
    ``runtime/loop.py::RatioSchedule.from_config`` (kept dependency-free
    here so a plan can be checked without torch; parity is asserted in
    tests/test_torch_planner.py)."""
    u = max(1, update_interval)
    e = max(1, env_steps_per_iter)
    return max(1, round(u / e)) if u >= e else 1


def aliasing_ok(publish_interval: int, period: int, n_shards: int,
                max_staleness: int) -> bool:
    """The ``AsyncExecutor``/``ShardedExecutor`` construction rule: shard
    d's staggered publish clock has fixed phase d mod P, so when P shares
    a factor g with the learn period, some shard's age exceeds the bound
    at *every* learn tick once min(g, n_shards) > max_staleness + 1 —
    that shard would be permanently dropped from the gradient reduce.
    The planner must never select a config the executor would refuse."""
    if publish_interval < 1 or n_shards <= 1:
        return True                      # no cross-shard reduce to drop from
    g = math.gcd(publish_interval, period)
    return min(g, n_shards) <= max_staleness + 1


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _resolve_n_envs(cand: Candidate) -> int:
    """Actor lanes the plan will run: the env count the point was
    *measured* at (so the executable config stays on the measured hull
    and realized-vs-predicted is a like-for-like comparison), rounded up
    to the shard count so the executor's divisibility check holds."""
    shards = max(1, cand.n_pods) * max(1, cand.n_data)
    return _round_up(max(cand.n_envs, shards), shards)


def feasible(cand: Candidate, *, update_interval: int, max_staleness: int,
             max_devices: Optional[int] = None, batch_size: int = 64) -> bool:
    """Whether a measured candidate can actually be instantiated with
    the requested knobs (device budget, batch divisibility, async
    publish/learn-period aliasing)."""
    shards = max(1, cand.n_pods) * max(1, cand.n_data)
    devices = shards if cand.n_data else 1
    if max_devices is not None and devices > max_devices:
        return False
    if batch_size % shards:
        return False
    if (cand.update_interval is not None
            and cand.update_interval != update_interval):
        # a point measured at a different collection/consumption ratio
        # is a different workload — its env-steps/s is not comparable
        # (legacy points without the field match any requested ratio)
        return False
    if cand.backend == "async":
        if cand.publish_interval < 1:
            return False
        period = learn_period(update_interval, _resolve_n_envs(cand))
        if not aliasing_ok(cand.publish_interval, period, shards,
                           max_staleness):
            return False
    return True


def select_replay_service(serve_points: Sequence[dict], *,
                          insert_rate: float, update_interval: int,
                          batch_size: int) -> Tuple[int, float]:
    """Choose the replay-service shape from measured ``figure="serve"``
    points (benchmarks/fig_serve.py): the service must sustain the
    chosen executor's insert rate AND the target sample rate it implies

        target_spi  = batch_size / update_interval
        sample_rate = target_spi · insert_rate

    Among configs whose *measured* inserts_per_s and samples_per_s both
    clear those requirements (with batch divisibility for stratified
    sampling), the fewest shards win — less cross-shard composition for
    the same sustained flow — tie-broken by headroom (the smaller of the
    two measured/required ratios).  Returns ``(n_replay_shards,
    samples_per_insert)``; ``(0, 0.0)`` when no measured config can
    sustain the flow — the plan keeps the replay in-loop rather than
    promising a service that would rate-limit the executor below its
    measured throughput.
    """
    target_spi = batch_size / max(1, update_interval)
    need_samples = target_spi * insert_rate
    eligible = []
    for p in serve_points:
        shards = int(p.get("n_shards", 1))
        if shards < 1 or batch_size % shards:
            continue
        ins = float(p.get("inserts_per_s", 0.0))
        smp = float(p.get("samples_per_s", 0.0))
        if ins >= insert_rate and smp >= need_samples:
            headroom = min(ins / max(insert_rate, 1e-9),
                           smp / max(need_samples, 1e-9))
            eligible.append((shards, -headroom, p))
    if not eligible:
        return 0, 0.0
    shards, _, _ = min(eligible)
    return shards, target_spi


# -- the planner -------------------------------------------------------------


def solve_lanes(actor_curve: Dict[int, float],
                learner_curve: Dict[int, float],
                total: int, update_interval: float = 1.0) -> dse.DSEResult:
    """Eq. 5 lane split — delegates to ``dse.solve`` so the planner is
    backward-compatible with the 1-D DSE on identical curves (asserted
    in tests/test_torch_planner.py)."""
    return dse.solve(actor_curve, learner_curve, total, update_interval)


def solve_backend_curves(
    backend_curves: Dict[str, Tuple[Dict[int, float], Dict[int, float]]],
    total: int,
    update_interval: float = 1.0,
) -> Tuple[str, dse.DSEResult]:
    """Curve-level backend selection: run Eq. 5 per backend's
    (actor_curve, learner_curve) pair and pick the backend whose solution
    best matches the ratio, tie-broken by measured collection throughput.

    This is the *curve-space* companion to :func:`plan`, for when only
    profiled curves exist (offline what-if analysis, fig12-style
    studies) — not the production selection path, and deliberately
    ordered differently: ``plan`` ranks whole measured configs by
    realized env-steps/s because each point already *is* the full
    workload, while here ratio feasibility must come first — each
    backend's Eq. 5 fit differs, and ranking curves by raw magnitude
    would just reward whichever curve carries the larger unit.

    Unit contract: actor curves must share one unit across backends
    (env-steps/s — what the BENCH schema enforces), and each backend's
    *pair* must be internally consistent (``update_interval × f_l`` in
    ``f_a``'s unit — Eq. 5 is meaningless otherwise).  What IS
    guaranteed unit-free: jointly rescaling one backend's pair leaves
    the ranking unchanged (the residual is divided by ``f_a``), and
    exact-fit ties break on the *relative* score
    (``dse.relative_score``) rather than raw magnitude — the raw
    ``-(fa + fl)`` sum this replaces let whichever backend's learner
    curve carried the larger unit win every tie.
    """
    if not backend_curves:
        raise ValueError("backend_curves is empty — nothing to select from")
    best = None
    for name, (ac, lc) in sorted(backend_curves.items()):
        res = dse.solve(ac, lc, total, update_interval)
        rel = dse.relative_score(res, ac, lc)
        # ratio feasibility first; among comparable fits the measured-
        # faster backend (absolute env-steps/s) wins; the relative score
        # breaks exact throughput ties unit-free
        key = (round(res.ratio_error, 6), -res.actor_throughput, rel)
        if best is None or key < best[0]:
            best = (key, name, res)
    return best[1], best[2]


def plan(
    fig9_points: Sequence[dict] = (),
    fig10_points: Sequence[dict] = (),
    *,
    serve_points: Sequence[dict] = (),
    actor_curve: Optional[Dict[int, float]] = None,
    learner_curve: Optional[Dict[int, float]] = None,
    total_lanes: int = 8,
    update_interval: int = 1,
    max_staleness: int = 1,
    max_devices: Optional[int] = None,
    batch_size: int = 64,
    source: str = "bench-json",
) -> PlannedConfig:
    """Choose the full runtime config from measured throughput.

    Scoring is realized env-steps/s over the *feasible measured*
    candidates (the config-level profiled hull) — :func:`profile` and
    ``benchmarks/run.py --emit-json`` measure every point at one global
    env count per sweep mode, so the comparison is the same workload
    under different runtime configs.  The winner keeps the env count it
    was measured at (only rounded up for shard divisibility), so the
    emitted config's throughput really was observed and the
    predicted-vs-realized gap in BENCH_plan.json measures planner error,
    not an env-count change.  The Eq. 5 lane split is solved alongside
    when actor/learner curves are provided (``x_actor``/``x_learner``
    report the host-level split; 0 when no curves) and decides ``n_envs``
    only on the curve-only fallback, where nothing was measured.  Ties
    prefer fewer devices, then a smaller publish_interval (less
    staleness for the same speed).

    When ``serve_points`` (measured replay-service throughput,
    benchmarks/fig_serve.py) are provided, a second selection stage
    picks ``n_replay_shards``/``samples_per_insert`` via
    :func:`select_replay_service` — the service shape that sustains the
    winning executor's measured insert rate at the implied target ratio,
    or 0/0.0 (in-loop replay) when none can.
    """
    lanes = None
    if actor_curve and learner_curve:
        lanes = solve_lanes(actor_curve, learner_curve, total_lanes,
                            update_interval)
    x_actor = lanes.x_actor if lanes else 0
    x_learner = lanes.x_learner if lanes else 0

    cands = candidates_from_points(fig9_points, fig10_points)
    ok = [c for c in cands
          if feasible(c, update_interval=update_interval,
                      max_staleness=max_staleness, max_devices=max_devices,
                      batch_size=batch_size)]
    # a config measured both emulated and on a real gang keeps only the
    # wall-clock measurement: emulated host devices time-slice one
    # process, so the gang number is the ground truth for the same
    # configuration (fig10 --wall-clock arm, DESIGN.md §10).  Dedup runs
    # *after* the ratio filter and keys on the config minus
    # update_interval: every survivor is either the requested ratio or a
    # legacy point with no recorded ratio, so a wall-clock survivor
    # shadows exactly the emulated measurement of its own config.
    by_config: Dict[Tuple, Candidate] = {}
    for c in ok:
        key = c.config_key[:-1]
        held = by_config.get(key)
        if held is None or (c.wallclock and not held.wallclock):
            by_config[key] = c
    ok = list(by_config.values())
    if not ok:
        if lanes:
            # curve-only fallback: the fused single-program config at the
            # Eq. 5 lane split, predicted from the actor curve
            return PlannedConfig(
                backend="fused", n_envs=max(1, x_actor),
                update_interval=update_interval, x_actor=x_actor,
                x_learner=x_learner,
                predicted_env_steps_per_s=lanes.actor_throughput,
                source=f"{source}:curves-only")
        raise ValueError(
            "no feasible measured candidate: every BENCH point was filtered "
            f"out (device budget {max_devices}, batch_size {batch_size}, "
            f"max_staleness {max_staleness}) and no lane curves were given "
            "to fall back on — re-run `python -m benchmarks.run "
            "--emit-json` or relax the constraints")

    best = min(ok, key=lambda c: (-c.env_steps_per_s,
                                  max(1, c.n_pods) * max(1, c.n_data),
                                  c.publish_interval))
    n_replay_shards, spi = (
        select_replay_service(serve_points, insert_rate=best.env_steps_per_s,
                              update_interval=update_interval,
                              batch_size=batch_size)
        if serve_points else (0, 0.0))
    return PlannedConfig(
        backend=best.backend,
        n_pods=best.n_pods,
        n_data=best.n_data,
        publish_interval=best.publish_interval,
        # the overlapped reduce is incompatible with bounded staleness
        # (runtime/learner.py) — an overlapped winner pins it to 0
        max_staleness=(max_staleness if best.backend == "async"
                       and best.n_data and not best.overlap else 0),
        compress_pod_reduce=best.compress,
        overlap_pod_reduce=best.overlap,
        n_envs=_resolve_n_envs(best),
        update_interval=update_interval,
        x_actor=x_actor,
        x_learner=x_learner,
        n_replay_shards=n_replay_shards,
        samples_per_insert=spi,
        predicted_env_steps_per_s=best.env_steps_per_s,
        source=f"{source}:{best.source}",
    )


# -- json I/O ----------------------------------------------------------------


def _load_points(path: str) -> List[dict]:
    with open(path) as f:
        payload = json.load(f)
    return list(payload.get("points", ()))


# the measurement-side fields of every figure (mirrors the union of
# benchmarks/schema.py metrics + dispersion records; kept inline because
# ``benchmarks`` is not importable from ``src``) — everything else on a
# point is identity
_MEASUREMENT_FIELDS = frozenset({
    "env_steps_per_s", "inserts_per_s", "samples_per_s",
    "replay_ops_per_s", "speedup_vs_sync", "repeats", "rel_spread",
    "realized_spi",
    # actor-serve figure (benchmarks/fig_actor.py) measurements
    "requests_per_s", "p50_ms", "p99_ms",
    "p99_before_swap_ms", "p99_after_swap_ms", "param_swaps",
})


def _point_identity(point: dict) -> Tuple:
    return tuple(sorted(
        (k, repr(v)) for k, v in point.items()
        if k not in _MEASUREMENT_FIELDS))


def merge_bench_points(bench_dir: str) -> Dict[str, List[dict]]:
    """Walk a directory tree of BENCH artifacts — several CI runs, a
    cron sweep, wall-clock arms dropped in subdirectories — and merge
    the points per figure.  Two points with the same identity fields are
    the same config measured twice: the one from the newest file (mtime)
    wins, so a stale artifact can never shadow a fresh measurement of
    the same config.  Plan envelopes (no ``points`` list) are skipped;
    unreadable json is tolerated (a partially written artifact must not
    kill planning over the rest of the directory)."""
    by_figure: Dict[str, Dict[Tuple, Tuple[float, dict]]] = {}
    for root, _dirs, files in sorted(os.walk(bench_dir)):
        for name in sorted(files):
            if not (name.startswith("BENCH_") and name.endswith(".json")):
                continue
            path = os.path.join(root, name)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            figure = payload.get("figure") if isinstance(payload, dict) \
                else None
            points = payload.get("points") if isinstance(payload, dict) \
                else None
            if not figure or not isinstance(points, list):
                continue
            mtime = os.path.getmtime(path)
            held = by_figure.setdefault(figure, {})
            for p in points:
                if not isinstance(p, dict):
                    continue
                key = _point_identity(p)
                if key not in held or mtime > held[key][0]:
                    held[key] = (mtime, p)
    return {figure: [p for _, p in held.values()]
            for figure, held in by_figure.items()}


def plan_from_json(bench_dir: str, **kwargs) -> PlannedConfig:
    """Plan from a *directory* of BENCH artifacts: every
    ``BENCH_*.json`` under ``bench_dir`` (recursively) is merged per
    figure with :func:`merge_bench_points` — identical configs keep the
    freshest measurement — so the planner sees the union of however many
    ``benchmarks/run.py --emit-json`` runs, wall-clock arms and service
    sweeps accumulated, not just one run's files.  Missing figures are
    tolerated; serve points (figure="serve") feed the replay-service
    selection stage automatically."""
    merged = merge_bench_points(bench_dir)
    fig9 = merged.get("fig9", [])
    fig10 = merged.get("fig10", [])
    if not fig9 and not fig10:
        raise FileNotFoundError(
            f"no fig9/fig10 BENCH points found under {bench_dir!r} — "
            "run `python -m benchmarks.run --emit-json DIR` first")
    kwargs.setdefault("source", f"json:{bench_dir}")
    kwargs.setdefault("serve_points", merged.get("serve", []))
    return plan(fig9, fig10, **kwargs)


def save_plan(pc: PlannedConfig, path: str, *,
              realized_env_steps_per_s: Optional[float] = None,
              curves: Optional[dict] = None) -> dict:
    """Write BENCH_plan.json: the chosen config plus predicted vs
    realized throughput (the autotuner's output becomes the next CI
    run's machine-readable trajectory)."""
    payload = {
        "figure": "plan",
        "metric": "env_steps_per_s",
        "config": pc.to_dict(),
        "predicted_env_steps_per_s": pc.predicted_env_steps_per_s,
        "realized_env_steps_per_s": realized_env_steps_per_s,
    }
    if curves:
        payload["curves"] = curves
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return payload


def load_plan(path: str) -> PlannedConfig:
    """Read a plan back — accepts the BENCH_plan.json envelope or a bare
    PlannedConfig dict, so hand-written plans work too."""
    with open(path) as f:
        payload = json.load(f)
    cfg = payload.get("config", payload)
    return PlannedConfig.from_dict(cfg)


# -- live profiling ----------------------------------------------------------


def profile(smoke: bool = False, device: str = "cuda") -> dict:
    """Measure the planner's inputs live on this machine through
    ``runtime/sweeps.py``: the fig9 executor-backend points (in this
    process), the fig10 shard/pod points (meshes of ranks, one a cell)
    and the fig12-style actor/learner lane curves for the Eq. 5 split.
    ``smoke`` shrinks every sweep to the reference's CI-budget sizes.  On
    the card unless ``device="cpu"``."""
    from repro_torch.runtime import sweeps

    # one global env count per mode, across BOTH sweeps: the planner
    # ranks fig9 and fig10 points against each other, which is only a
    # like-for-like comparison when every point runs the same workload
    if smoke:
        fig9_pts = sweeps.executor_backend_points(
            publish_intervals=(1, 2), n_envs=8, iters=40, device=device)
        fig10_pts = sweeps.shard_pod_points(
            shard_counts=(1, 2), pod_specs=((2, 1, False),),
            n_envs=8, iters=40, device=device)
        lanes = (1, 2, 4)
    else:
        fig9_pts = sweeps.executor_backend_points(n_envs=16, device=device)
        fig10_pts = sweeps.shard_pod_points(n_envs=16, device=device)
        lanes = (1, 2, 4, 8)
    actor_curve = dse.profile_curve(lambda x: sweeps.actor_throughput(x, device), list(lanes))
    learner_curve = dse.profile_curve(lambda x: sweeps.learner_throughput(x, device),
                                      list(lanes))
    return {
        "fig9_points": fig9_pts,
        "fig10_points": fig10_pts,
        "actor_curve": actor_curve,
        "learner_curve": learner_curve,
    }
