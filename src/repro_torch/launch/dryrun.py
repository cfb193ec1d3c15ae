"""Multi-pod dry run — port of ``repro.launch.dryrun``: every (architecture
× input shape × mesh) cell run on the meta device over a fake process
group of the production mesh's 256 (16×16) or 512 (2×16×16, run as its
equivalent 32×16: ``launch/mesh.py::dryrun_mesh``) ranks, with its
roofline terms on an H100 (``launch/roofline.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch internlm2_1_8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out DIR]

A cell is the reference's: ``train_step`` (train_4k), ``prefill``
(prefill_32k) or ``serve_step`` on a full KV cache (decode_32k,
long_500k), sharded by ``sharding_config`` on the production mesh.  It
allocates nothing: the parameters, state, cache and inputs are DTensors of
meta pieces (``launch/mesh.py::dryrun_mesh``; the flash kernels' meta
stand-ins), so rank 0 runs its own ops at their real shapes.

Each cell writes a JSON record:
  * ``state_bytes_per_device`` / ``cache_bytes_per_device``: from the spec
    trees (``specs.tree_device_bytes``), and beside them the bytes rank 0's
    pieces really hold (``held_*``);
  * the compute term: the FLOPs of the unsharded, accum-1 step under
    ``FlopCounterMode`` on the meta device (the probe; every matmul of the
    step, a recurrence's every step included), plus the flash kernels'
    analytic FLOPs (invisible on meta), as the reference's probe plus its
    corrections.  ``FlopCounterMode`` counts matmuls, where XLA's cost
    analysis counts elementwise FLOPs too;
  * the memory term: ``bytes_unfused``, the input plus output bytes of
    every op rank 0 runs in the sharded step (views and allocations move
    nothing and are left out), times the chips.  That is what eager
    PyTorch moves, op by op; it is not XLA's fused figure;
  * the collective term: every collective the sharded step runs (DTensor's
    redistributions and the model's own), its output bytes and group, with
    the reference's ring factors.  On a CPU or meta mesh DTensor turns a
    shard-to-shard move into an all-gather and a slice, where NCCL would
    run an all-to-all.

The sharded run is made at reduced size and extrapolated, exactly: the
stacks at one and two units of each layer signature (units of one
signature, their attention layers global or not alike, run the same ops
once the residual stream enters each unit with one sharding, so every
count is linear in their number; ``_depth_stencil``), a train
step with gradient accumulation at two and three microbatches (linear in
the microbatches past the first two; ``_accum_stencil``), and an xLSTM
sequence at two and three steps of its recurrences, or three and four
chunks with the chunked mLSTM (every count of the ssm family is linear in
the steps from the second on and in the chunks from the third on; at
fewer the sharded run takes other collectives; ``_seq_stencil``), so no
cell loops 32,768 times.  The probe takes the same depth and sequence
stencils.  ``tests/test_torch_dryrun.py`` holds each stencil's sum against
the run at full size on a fake 2×2 mesh.
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.agents import token_dqn
from repro_torch.agents.token_dqn import TokenDQNConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as shp
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharded
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (dryrun_mesh, dryrun_sharding, make_production_mesh,
                                    sharding_config)
from repro_torch.models import backbone
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig
from repro_torch.optim import adam

OUT_DIR = "experiments/dryrun_torch"


def choose_tcfg(cfg: ModelConfig, case: shp.ShapeCase, fsdp_size: int) -> TokenDQNConfig:
    """Accum so each device sees ~1 sequence per microbatch at ≥4B scale,
    and bf16 optimizer state for the biggest archs (HBM budget)."""
    big = cfg.d_model >= 4096 or cfg.num_experts >= 64
    per_dev = max(1, case.global_batch // fsdp_size)
    accum = per_dev if big else max(1, per_dev // 4)
    # accum must divide global_batch and keep microbatch divisible by fsdp
    while case.global_batch % accum or (case.global_batch // accum) % fsdp_size:
        accum -= 1
    state_dtype = "bfloat16" if big else None
    return TokenDQNConfig(accum=accum,
                          opt=adam.AdamConfig(lr=3e-5, state_dtype=state_dtype))


OPT_OVERRIDES = dict(attn_impl="flash", moe_ff_tp_fallback=True,
                     mlstm_chunked=True, moe_local_dispatch=True)


def optimized(cfg: ModelConfig) -> ModelConfig:
    """Beyond-paper §Perf configuration (baseline stays 'naive')."""
    return dataclasses.replace(cfg, **OPT_OVERRIDES)


# -- what a run records ------------------------------------------------------------

COLLECTIVES = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
# ops that move no bytes: allocations without a fill, and aliases
NO_TRAFFIC = {"aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
              "aten.new_empty_strided", "aten.detach", "aten.alias", "aten.lift_fresh",
              "aten._unsafe_view", "_c10d_functional.wait_tensor",
              "_c10d_functional._wrap_tensor_autograd"}


@dataclasses.dataclass
class Tally:
    """What one rank ran: ``ops`` {(op, shapes): [calls, bytes]},
    ``colls`` {(collective, group size, output bytes): calls}, ``flops``
    (the probe's), and ``held`` {name: bytes of rank 0's pieces}."""

    ops: Dict[Tuple[str, str], List[float]] = dataclasses.field(default_factory=dict)
    colls: Dict[Tuple[str, int, float], float] = dataclasses.field(default_factory=dict)
    flops: float = 0.0
    held: Dict[str, float] = dataclasses.field(default_factory=dict)

    @staticmethod
    def combine(terms: List[Tuple[float, "Tally"]]) -> "Tally":
        """Σ coefficient × tally, key by key (an extrapolation stencil)."""
        out = Tally()
        for coef, t in terms:
            for key, (calls, nbytes) in t.ops.items():
                row = out.ops.setdefault(key, [0.0, 0.0])
                row[0] += coef * calls
                row[1] += coef * nbytes
            for key, calls in t.colls.items():
                out.colls[key] = out.colls.get(key, 0.0) + coef * calls
            out.flops += coef * t.flops
            for key, nbytes in t.held.items():
                out.held[key] = out.held.get(key, 0.0) + coef * nbytes
        return out

    @property
    def bytes_unfused(self) -> float:
        return sum(nbytes for _, nbytes in self.ops.values())

    def collective_stats(self) -> RL.CollectiveStats:
        return RL.collective_stats((op, nbytes, n, calls)
                                   for (op, n, nbytes), calls in self.colls.items()
                                   if abs(calls) > 1e-9)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _label(tensors: List[torch.Tensor]) -> str:
    shapes = ["x".join(map(str, t.shape)) or "()" for t in tensors[:3]]
    more = f"+{len(tensors) - 3}" if len(tensors) > 3 else ""
    return ",".join(shapes) + more


def _group_size(func, args) -> int:
    if func._opname in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[1] if func._opname == "all_gather_into_tensor" else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class Recorder(TorchDispatchMode):
    """Records the ops rank 0 runs.  A DTensor op is recorded whole, from
    its local pieces (its inputs as they come, before DTensor redistributes
    them, and its output), and then run with this mode still active,
    handed on to DTensor (``NotImplemented``): the collectives of its
    redistributions come back here and are recorded, its local compute is
    not (DTensor runs it natively on a cached placement).  An op on plain
    tensors outside any DTensor op (the unsharded probe, or the model's own
    work on local pieces) is recorded as it is."""

    def __init__(self):
        super().__init__()
        self.tally = Tally()
        self._inside = False

    def _add(self, name, ins, outs):
        row = self.tally.ops.setdefault((name, f"{_label(ins)}->{_label(outs)}"), [0.0, 0.0])
        row[0] += 1
        row[1] += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        name = f"{func.namespace}.{func._opname}"
        if any(issubclass(t, DTensor) for t in types):
            if self._inside:
                return NotImplemented
            self._inside = True
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._inside = False
            if not (func.is_view or name in NO_TRAFFIC):
                self._add(name, [L.local(t) for t in tree_leaves((args, kwargs))
                                 if isinstance(t, torch.Tensor)],
                          [L.local(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor)])
            return out
        out = func(*args, **kwargs)
        collective = func.namespace == "_c10d_functional" and func._opname in COLLECTIVES
        if func.is_view or name in NO_TRAFFIC or (self._inside and not collective):
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if collective:
            key = (COLLECTIVES[func._opname], _group_size(func, args),
                   float(sum(map(_nbytes, outs))))
            self.tally.colls[key] = self.tally.colls.get(key, 0.0) + 1
        self._add(name, ins, outs)
        return out


def _held(tensors) -> float:
    return float(sum(_nbytes(L.local(t)) for t in tensors))


# -- one run at a given size ---------------------------------------------------------


def _inputs(cfg: ModelConfig, case: shp.ShapeCase, shd: ShardingConfig, device_mesh):
    """The cell's inputs on the meta device, their batch over the data
    axes on a mesh (the reference's ``batch_specs``)."""
    specs = (shp.learner_batch_specs(cfg, case) if case.kind == "train"
             else shp.token_specs(cfg, case))
    batch = shp.meta_tensors(specs)
    return batch if device_mesh is None else sharded.shard_batch(shd, batch, device_mesh)


def _step(cfg: ModelConfig, case: shp.ShapeCase, tcfg: TokenDQNConfig, shd: ShardingConfig,
          device_mesh, mode) -> Tally:
    """One cell's step at ``cfg``/``case``'s size under ``mode`` (a
    ``Recorder`` or a ``FlopCounterMode``): sharded on ``device_mesh``, or
    unsharded without one (the probe).  Returns the recorder's tally (the
    bytes rank 0's pieces hold in ``held``) or the FLOPs."""
    params = backbone.shape_params(cfg)
    held: Dict[str, float] = {}
    if case.kind == "train":
        target = copy.deepcopy(params).requires_grad_(False)
        if device_mesh is None:
            state = token_dqn.TrainState(params, target, adam.init(params.parameters(), tcfg.opt),
                                         torch.zeros((), dtype=torch.int32, device="meta"))
        else:
            state = sharded.shard_train_state(cfg, shd, tcfg, params, target, device_mesh)
            held["state"] = float(sharded.local_state_bytes(state))
        batch = _inputs(cfg, case, shd, device_mesh)
        with mode:
            token_dqn.train_step(cfg, shd, tcfg, state, batch)
    else:
        if device_mesh is not None:
            sharded.shard_params(cfg, shd, params, device_mesh)
            held["state"] = _held(params.parameters())
        inputs = _inputs(cfg, case, shd, device_mesh)
        if case.kind == "prefill":
            with mode:
                backbone.prefill(cfg, params, inputs["tokens"], case.seq_len,
                                 inputs.get("extra_embeds"), shd=shd)
        else:
            cache = backbone.init_cache(cfg, case.global_batch, case.seq_len, device="meta",
                                        shd=shd, device_mesh=device_mesh)
            held["cache"] = _held(S.flat_leaves(cache).values())
            with mode:
                token_dqn.serve_step(cfg, params, cache, inputs["tokens"], None, shd)
    if isinstance(mode, Recorder):
        mode.tally.held = held
        return mode.tally
    return Tally(flops=float(mode.get_total_flops()))


def _depth_stencil(cfg: ModelConfig) -> List[Tuple[float, ModelConfig]]:
    """[(coefficient, config at one or two units)] whose runs, summed with
    the coefficients, give the full stack's: the units grouped by
    signature (which of their attention layers are global), one run of one
    and two units of the commonest signature and one of one unit of each
    other (their global layers set by ``global_layers``).  The ssm family
    (few blocks of two kinds, whose backward differs by the kind that
    follows a block), and an encoder as deep as no decoder, run whole."""
    if cfg.family == "ssm":
        return [(1.0, cfg)]
    sub, n_units = backbone.unit_structure(cfg)
    if n_units <= 2 or (cfg.family == "audio" and cfg.encoder_layers != n_units):
        return [(1.0, cfg)]
    per_unit = cfg.num_layers // n_units
    n_attn = sum(1 for k in sub if k in ("attn", "hybrid"))
    sigs = collections.Counter(tuple(row) for row in backbone._global_flags(cfg, n_units, sub))
    s0 = max(sigs, key=sigs.get)

    def at(sig, k):
        glob = tuple(u * n_attn + j for u in range(k) for j, f in enumerate(sig) if f)
        over = dict(num_layers=k * per_unit, global_layers=glob, global_layer_period=0)
        if cfg.family == "audio":
            over["encoder_layers"] = k
        return dataclasses.replace(cfg, **over)

    out = [(float(n_units - 1), at(s0, 2)), (float(2 * (1 - n_units) + sigs[s0]), at(s0, 1))]
    return out + [(float(n), at(s, 1)) for s, n in sigs.items() if s != s0]


def _seq_stencil(cfg: ModelConfig, case: shp.ShapeCase) -> List[Tuple[float, int]]:
    """[(coefficient, sequence length)]: an ssm model's train or prefill at
    two and three recurrence steps (three and four chunks, with the chunked
    mLSTM), extrapolated to the case's length; any other cell, or a
    sequence no longer than the stencil's, at its own."""
    c, k = (X.MLSTM_CHUNK, 3) if (cfg.mlstm_chunked and case.kind == "train") else (1, 2)
    s, s1, s2 = case.seq_len, k * c, (k + 1) * c
    if cfg.family != "ssm" or case.kind == "decode" or s <= s2:
        return [(1.0, s)]
    return [((s2 - s) / (s2 - s1), s1), ((s - s1) / (s2 - s1), s2)]


def _accum_stencil(accum: int) -> List[Tuple[float, int]]:
    """[(coefficient, microbatches)]: accumulation past two microbatches
    repeats the same loop body, so three runs' difference from two is one
    microbatch's."""
    if accum <= 2:
        return [(1.0, accum)]
    return [(3.0 - accum, 2), (accum - 2.0, 3)]


def measure(cfg: ModelConfig, case: shp.ShapeCase, tcfg: TokenDQNConfig, shd: ShardingConfig,
            device_mesh) -> Tally:
    """The cell's tally: the sharded step's ops, collectives and held
    bytes on ``device_mesh``, each from its stencil's runs, and the probe's
    FLOPs (``build_probe``)."""
    mb = case.global_batch // tcfg.accum
    runs: List[Tuple[float, Tally]] = []
    for a_d, cfg_d in _depth_stencil(cfg):
        for a_s, seq in _seq_stencil(cfg, case):
            case_s = dataclasses.replace(case, seq_len=seq)
            accums = _accum_stencil(tcfg.accum) if case.kind == "train" else [(1.0, 1)]
            for a_a, acc in accums:
                case_r = dataclasses.replace(case_s, global_batch=mb * acc)
                tcfg_r = dataclasses.replace(tcfg, accum=acc)
                runs.append((a_d * a_s * a_a, _step(cfg_d, case_r, tcfg_r, shd, device_mesh,
                                                    Recorder())))
    tally = Tally.combine(runs)
    tally.flops = build_probe(cfg, case, tcfg)
    return tally


def build_probe(cfg: ModelConfig, case: shp.ShapeCase, tcfg: TokenDQNConfig) -> float:
    """The cost probe (the reference's ``build_probe``): the FLOPs of the
    unsharded, accum-1 step at the cell's full batch under
    ``FlopCounterMode`` on the meta device, from the depth and sequence
    stencils' runs (the reference lowers it unrolled and unpartitioned for
    XLA's cost analysis)."""
    from torch.utils.flop_counter import FlopCounterMode

    probe_t = dataclasses.replace(tcfg, accum=1)
    return sum(a_d * a_s * _step(cfg_d, dataclasses.replace(case, seq_len=seq), probe_t,
                                 NO_SHARDING, None, FlopCounterMode(display=False)).flops
               for a_d, cfg_d in _depth_stencil(cfg) for a_s, seq in _seq_stencil(cfg, case))


# -- cells ----------------------------------------------------------------------------


def cell_info(cfg: ModelConfig, case: shp.ShapeCase, shd: ShardingConfig, mesh
              ) -> Tuple[TokenDQNConfig, Dict[str, Any]]:
    """(the train config, the cell's static info) on ``mesh`` (only its
    axis sizes are read): the bytes a device holds, from the spec trees."""
    fsdp_size = 1
    for a in shd.fsdp:
        fsdp_size *= mesh.shape[a]
    tcfg = TokenDQNConfig()
    if case.kind == "train":
        tcfg = choose_tcfg(cfg, case, fsdp_size)
        state, specs = sharded.state_shapes(cfg, shd, tcfg.opt.state_dtype or "float32")
        return tcfg, {"kind": "train", "accum": tcfg.accum,
                      "state_bytes_per_device": S.tree_device_bytes(state, specs, mesh)}
    params = backbone.shape_params(cfg)
    leaves = {n: (tuple(p.shape), p.dtype) for n, p in params.named_parameters()}
    info = {"kind": case.kind, "state_bytes_per_device": S.tree_device_bytes(
        leaves, backbone.param_specs(cfg, shd, params), mesh)}
    if case.kind == "decode":
        cache = backbone.init_cache(cfg, case.global_batch, case.seq_len, device="meta")
        info["cache_bytes_per_device"] = S.tree_device_bytes(
            S.flat_leaves(cache), S.flat_leaves(S.cache_specs(cfg, shd, cache)), mesh)
    return tcfg, info


def build_cell(arch: str, shape: str, multi_pod: bool, opt: bool = False):
    """Returns (run_fn, static info) for the cell: the info from shapes
    alone on the production mesh (nothing runs); ``run_fn()`` runs the cell
    on the production mesh's fake ``DeviceMesh`` (``dryrun_mesh``) → its
    tally."""
    cfg = get_config(arch)
    if opt:
        cfg = optimized(cfg)
    case = shp.SHAPES[shape]
    if not shp.runnable(cfg, shape):
        return None, {"skipped": True,
                      "reason": "long_500k requires sub-quadratic attention "
                                "(DESIGN.md §5)"}
    tcfg, info = cell_info(cfg, case, sharding_config(multi_pod),
                           make_production_mesh(multi_pod=multi_pod))

    def run() -> Tally:
        return measure(cfg, case, tcfg, dryrun_sharding(multi_pod), dryrun_mesh(multi_pod))

    return run, info


def _top_ops(tally: Tally, top: int) -> List[Tuple[float, float, str, str]]:
    """[(bytes, calls, op, shapes)] of the ``top`` ops by bytes."""
    rows = sorted(((nbytes, calls, op, shapes) for (op, shapes), (calls, nbytes)
                   in tally.ops.items()), reverse=True)
    return rows[:top]


def cell_record(tally: Tally, cfg: ModelConfig, case: shp.ShapeCase,
                chips: int) -> Dict[str, Any]:
    """The roofline record of a measured cell."""
    coll = tally.collective_stats()
    flash = RL.flash_attention_flops(cfg, case, case.kind == "train")
    g_flops = tally.flops + flash
    g_bytes = tally.bytes_unfused * chips
    terms = RL.cost_terms(g_flops, g_bytes, chips, coll)
    mf = RL.model_flops(cfg, case)
    rec = {
        "flops_probe": tally.flops,
        "flops_flash_analytic": flash,
        "flops_recurrence_reference": RL.recurrence_flops_correction(
            cfg, case, case.kind == "train"),
        "bytes_unfused_per_device": tally.bytes_unfused,
        "collectives": coll.counts,
        "collective_raw_bytes": coll.raw_bytes,
        **terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / g_flops if g_flops else None),
        "dominant": RL.dominant(terms),
        "top_ops": [[b, c, op, sh] for b, c, op, sh in _top_ops(tally, 10)],
    }
    for key in ("state", "cache"):
        if key in tally.held:
            rec[f"held_{key}_bytes_per_device"] = tally.held[key]
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, opt: bool = False) -> Dict[str, Any]:
    tag = f"{arch}_{shape}_{'pod2' if multi_pod else 'pod1'}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = optimized(get_config(arch)) if opt else get_config(arch)
    case = shp.SHAPES[shape]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "opt": opt,
        "mesh": [2, 16, 16] if multi_pod else [16, 16],
        "device": "meta (fake process group); terms from H100 SXM datasheet constants",
    }
    t0 = time.time()
    try:
        run, info = build_cell(arch, shape, multi_pod, opt=opt)
        rec.update(info)
        if info.get("skipped"):
            rec["status"] = "skipped"
        else:
            tally = run()
            rec.update(cell_record(tally, cfg, case, 512 if multi_pod else 256))
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"[{tag}] {rec['status']} ({rec['total_s']}s) "
          f"dominant={rec.get('dominant')} err={rec.get('error', '')[:120]}", flush=True)
    return rec


def terms_line(rec: Dict[str, Any]) -> str:
    """One line of a cell's terms (seconds) and bytes a device."""
    if rec.get("status") != "ok":
        return f"{rec['arch']} {rec['shape']}: {rec.get('status')}"
    return (f"{rec['arch']} {rec['shape']} mesh={'x'.join(map(str, rec['mesh']))}: "
            f"t_compute={rec['t_compute']:.6g}s t_memory={rec['t_memory']:.6g}s "
            f"t_collective={rec['t_collective']:.6g}s dominant={rec['dominant']} "
            f"state={rec['state_bytes_per_device'] / 1e9:.4g}GB/device")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="beyond-paper optimized config (writes to --out)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = OUT_DIR + ("_opt" if args.opt else "")

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes_ = list(shp.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes_:
                cells.append((a, s, mp))

    ok = err = skipped = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, mp, args.out, args.force, opt=args.opt)
        st = rec["status"]
        ok += st == "ok"
        err += st == "error"
        skipped += st == "skipped"
        print(terms_line(rec), flush=True)
    print(f"\ndry-run summary: {ok} ok, {skipped} skipped, {err} errors "
          f"of {len(cells)} cells")
    raise SystemExit(1 if err else 0)


if __name__ == "__main__":
    main()
