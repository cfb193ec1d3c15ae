"""The dry run (``launch/dryrun.py``, ``launch/roofline.py``,
``launch/mesh.py::fake_device_mesh``) against ``repro.launch.dryrun`` and
``repro.launch.hlo_analysis``, on the CPU.

  * ``choose_tcfg`` and ``build_cell``'s info (kind, accum, skipped,
    state and cache bytes a device) exactly, for every (arch, shape, mesh)
    cell, against the reference's ``build_cell`` in a subprocess of 512
    forced host devices.  The cache's ``pos`` is left out on both sides:
    the port keeps one position a row where the reference keeps a scalar.
  * ``param_count``, ``model_flops``, ``flash_attention_flops``,
    ``recurrence_flops_correction`` and ``dominant`` exactly; ``cost_terms``
    with the port's H100 constants given to both sides.
  * The probe's FLOPs (``FlopCounterMode`` on the meta device) of one
    dense SMOKE prefill and one train step equal a closed form of their
    GEMMs.
  * A SMOKE cell of each family on a fake 4×4 mesh ends ``ok``, its
    extrapolated held bytes equal to ``tree_device_bytes``; a 1×1 fake mesh
    records no collective.
  * The extrapolation stencils (depth, gradient accumulation, xLSTM
    steps and chunks) summed equal the run at full size on a fake 2×2
    mesh: the bytes of every op, the collectives' calls and bytes, the
    probe's FLOPs and the held bytes.
Those on a fake mesh run in subprocesses of their own, since the fake
process group is its process's default group.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget
from repro.configs import shapes as jshp
from repro.launch import hlo_analysis as HA
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as shp
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.models.config import NO_SHARDING

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

REFERENCE = r'''
import os, pickle, sys
from repro.launch import dryrun
from repro.configs import ARCH_IDS
from repro.configs import shapes as shp
out = {}
for mp in (False, True):
    for arch in ARCH_IDS:
        for shape in shp.SHAPES:
            _, info = dryrun.build_cell(arch, shape, mp)
            out[(arch, shape, mp)] = info
            if info.get("kind") == "train":
                t = dryrun.choose_tcfg(dryrun.get_config(arch), shp.SHAPES[shape],
                                       32 if mp else 16)
                out[("tcfg", arch, shape, mp)] = (t.accum, t.opt.lr, t.opt.state_dtype)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''

# one SMOKE cell a family on a fake 4×4 mesh, and a 1×1 mesh
SMOKE_CELLS = (("internlm2_1_8b", "train_4k"), ("mixtral_8x7b", "decode_32k"),
               ("phi_3_vision_4_2b", "prefill_32k"), ("hymba_1_5b", "decode_32k"),
               ("xlstm_125m", "train_4k"), ("whisper_medium", "decode_32k"))

ONE_BY_ONE = ("internlm2_1_8b", "prefill_32k")

SMOKE = r'''
import math, pickle, sys
from repro_torch.configs import get_config
from repro_torch.configs import shapes as shp
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, fake_device_mesh, sharding_config
out = {}
shd = sharding_config(False)
for sizes, cells in CELLS:
    dm = fake_device_mesh(("data", "model"), sizes)
    for arch, shape in cells:
        cfg, case = get_config(arch, smoke=True), shp.SHAPES[shape]
        tcfg, info = D.cell_info(cfg, case, shd, Mesh(("data", "model"), sizes))
        tally = D.measure(cfg, case, tcfg, shd, dm)
        rec = D.cell_record(tally, cfg, case, math.prod(sizes))
        out[(arch, shape, sizes)] = {"info": info, "held": tally.held, "rec": rec,
                                     "colls": dict(tally.colls)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''

# (name, arch, config overrides, (seq_len, global_batch, kind), accum): a
# stack of 4 units at accum 4; 5 units of two signatures (3 global
# attention layers, 2 local); xLSTM at 4 steps of its recurrences (sLSTM
# and mLSTM, train and prefill) and at 5 chunks of the chunked mLSTM (its
# stencils run 2 and 3 steps, 3 and 4 chunks); one process a group
STENCIL_CASES = (
    (("depth_accum", "internlm2_1_8b", {"num_layers": 4}, (64, 8, "train"), 4),),
    (("xlstm_chunks", "xlstm_125m", {"mlstm_chunked": True, "slstm_at": (), "num_layers": 1},
      (5 * 64, 4, "train"), 1),),
    (("signatures", "hymba_1_5b", {"num_layers": 5, "global_layers": (0, 2, 4)},
      (64, 4, "decode"), 1),
     ("xlstm_steps_train", "xlstm_125m", {}, (4, 4, "train"), 1),
     ("xlstm_steps_prefill", "xlstm_125m", {}, (4, 4, "prefill"), 1)),
)

STENCIL = r'''
import collections, dataclasses, pickle, sys
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.configs import shapes as shp
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_device_mesh, sharding_config
from repro_torch.models.config import NO_SHARDING

def summary(t):
    ops, colls = collections.defaultdict(lambda: [0.0, 0.0]), collections.defaultdict(float)
    for (op, _), (calls, nbytes) in t.ops.items():
        ops[op][0] += calls
        ops[op][1] += nbytes
    for (kind, n, nbytes), calls in t.colls.items():
        colls[(kind, n, "calls")] += calls
        colls[(kind, n, "bytes")] += calls * nbytes
    return {"ops": dict(ops), "colls": dict(colls), "flops": t.flops, "held": t.held,
            "bytes": t.bytes_unfused}

shd = sharding_config(False)
dm = fake_device_mesh(("data", "model"), (2, 2))
out = {}
for name, arch, over, (seq, batch, kind), accum in CASES:
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    case, tcfg = shp.ShapeCase(name, seq, batch, kind), D.TokenDQNConfig(accum=accum)
    full = D._step(cfg, case, tcfg, shd, dm, D.Recorder())
    full.flops = D._step(cfg, case, dataclasses.replace(tcfg, accum=1), NO_SHARDING, None,
                         FlopCounterMode(display=False)).flops
    out[name] = {"stencil": summary(D.measure(cfg, case, tcfg, shd, dm)),
                 "full": summary(full),
                 "runs": (len(D._depth_stencil(cfg)), len(D._seq_stencil(cfg, case)),
                          len(D._accum_stencil(accum)))}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "ref.pkl")], env=env)
    # the two train cells take the longest: each a process, beside the rest
    parts = [[((4, 4), SMOKE_CELLS[:1])], [((4, 4), SMOKE_CELLS[4:5])],
             [((4, 4), SMOKE_CELLS[1:4] + SMOKE_CELLS[5:]), ((1, 1), [ONE_BY_ONE])]]
    smoke = [subprocess.Popen([sys.executable, "-c", f"CELLS = {cells!r}\n" + SMOKE,
                               str(tmp / f"smoke{i}.pkl")], env=env)
             for i, cells in enumerate(parts)]
    stencil = [subprocess.Popen([sys.executable, "-c", f"CASES = {cases!r}\n" + STENCIL,
                                 str(tmp / f"stencil{i}.pkl")], env=env)
               for i, cases in enumerate(STENCIL_CASES)]
    assert all(p.wait(timeout=600) == 0 for p in smoke + stencil)
    assert ref.wait(timeout=600) == 0
    out = {"smoke": {}}
    with open(tmp / "ref.pkl", "rb") as f:
        out["ref"] = pickle.load(f)
    for i in range(len(parts)):
        with open(tmp / f"smoke{i}.pkl", "rb") as f:
            out["smoke"].update(pickle.load(f))
    out["stencil"] = {}
    for i in range(len(STENCIL_CASES)):
        with open(tmp / f"stencil{i}.pkl", "rb") as f:
            out["stencil"].update(pickle.load(f))
    return out


def _pos_bytes(cfg, case, reference):
    return 4 if reference else 8 * case.global_batch


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_info_matches_reference(arch, multi_pod, runs):
    for shape, case in shp.SHAPES.items():
        _, got = D.build_cell(arch, shape, multi_pod)
        want = dict(runs["ref"][(arch, shape, multi_pod)])
        got = dict(got)
        assert set(got) == set(want), (shape, got, want)
        if "cache_bytes_per_device" in got:
            got["cache_bytes_per_device"] -= _pos_bytes(get_config(arch), case, False)
            want["cache_bytes_per_device"] -= _pos_bytes(get_config(arch), case, True)
        assert got == want, (arch, shape, multi_pod)
        if got.get("kind") == "train":
            t = D.choose_tcfg(get_config(arch), case, 32 if multi_pod else 16)
            assert (t.accum, t.opt.lr, t.opt.state_dtype) == \
                runs["ref"][("tcfg", arch, shape, multi_pod)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_functions_match_reference(arch):
    for opt in (False, True):
        cfg, jcfg = get_config(arch), jget(arch)
        if opt:
            cfg = D.optimized(cfg)
            jcfg = dataclasses.replace(jcfg, **D.OPT_OVERRIDES)
        assert RL.param_count(cfg) == HA.param_count(jcfg)
        for shape in shp.SHAPES:
            case, jcase = shp.SHAPES[shape], jshp.SHAPES[shape]
            assert RL.model_flops(cfg, case) == HA.model_flops(jcfg, jcase)
            for train in (False, True):
                assert RL.flash_attention_flops(cfg, case, train) == \
                    HA.flash_attention_flops(jcfg, jcase, train)
                assert RL.recurrence_flops_correction(cfg, case, train) == \
                    HA.recurrence_flops_correction(jcfg, jcase, train)


def test_cost_terms_and_dominant_match_reference(monkeypatch):
    rows = [("all-gather", 3.0e8, 16, 4.0), ("reduce-scatter", 1.5e7, 16, 2.0),
            ("all-reduce", 6.4e6, 32, 5.0), ("all-to-all", 1.0e6, 16, 1.0),
            ("collective-permute", 2.0e5, 2, 3.0)]
    coll = RL.collective_stats(rows)
    jcoll = HA.CollectiveStats({}, 0.0, {}, [])
    for op, nbytes, n, count in rows:     # the reference's per-line ring factors
        line = (f"%c = f32[{int(nbytes) // 4}] {op}(%x), "
                f"replica_groups={{{{{','.join(map(str, range(n)))}}}}}")
        _, b, gn, w = HA._line_collective(line)
        jcoll.counts[op] = jcoll.counts.get(op, 0.0) + count
        jcoll.raw_bytes[op] = jcoll.raw_bytes.get(op, 0.0) + b * count
        jcoll.wire_bytes += w * count
        assert gn == n and b == nbytes
    assert coll.counts == jcoll.counts and coll.raw_bytes == jcoll.raw_bytes
    assert coll.wire_bytes == pytest.approx(jcoll.wire_bytes, rel=1e-15)
    monkeypatch.setattr(HA, "PEAK_FLOPS", RL.PEAK_FLOPS)
    monkeypatch.setattr(HA, "HBM_BW", RL.HBM_BW)
    monkeypatch.setattr(HA, "ICI_BW", RL.LINK_BW)
    for flops, nbytes, chips in ((2.1e16, 1.4e15, 256), (3.0e13, 2.0e12, 512), (1e9, 1e15, 16)):
        got = RL.cost_terms(flops, nbytes, chips, coll)
        want = HA.cost_terms(flops, nbytes, chips, jcoll)
        assert got == pytest.approx(want, rel=1e-15)
        assert RL.dominant(got) == HA.dominant(want)
    # the port's constants are the H100's, none of the TPU's
    assert (RL.PEAK_FLOPS, RL.HBM_BW) == (989e12, 3.35e12)


def _gemm_flops(cfg, b, s):
    """Closed form of a dense forward's GEMMs: the projections, QKᵀ and PV
    of every head, the GLU's three and the output projection."""
    t, d, h, kv, hd, f, v = (b * s, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                             cfg.d_ff, cfg.vocab_size)
    unit = (2 * t * d * h * hd + 2 * 2 * t * d * kv * hd + 2 * t * h * hd * d
            + 2 * 2 * b * h * s * s * hd + 3 * 2 * t * d * f)
    return cfg.num_layers * unit, 2 * t * d * v


def test_probe_flops_equal_the_gemms():
    cfg = get_config("internlm2_1_8b", smoke=True)
    b, s = 4, 128
    units, head = _gemm_flops(cfg, b, s)
    pre = D._step(cfg, shp.ShapeCase("p", s, b, "prefill"), D.TokenDQNConfig(), NO_SHARDING,
                  None, FlopCounterMode(display=False))
    assert pre.flops == units + head
    # train: the online forward, the target's, the backward's two GEMMs for
    # every forward one, and the units again (remat), but for each unit's
    # last GEMM, the MLP's down projection, whose output the backward does
    # not need (the checkpoint's recomputation stops before it)
    train = D._step(cfg, shp.ShapeCase("t", s, b, "train"), D.TokenDQNConfig(), NO_SHARDING,
                    None, FlopCounterMode(display=False))
    down = cfg.num_layers * 2 * b * s * cfg.d_ff * cfg.d_model
    assert train.flops == 4 * (units + head) + units - down


@pytest.mark.parametrize("cell", SMOKE_CELLS, ids=lambda c: c[0])
def test_smoke_cells_on_a_fake_mesh(cell, runs):
    got = runs["smoke"][(*cell, (4, 4))]
    rec, info, held = got["rec"], got["info"], got["held"]
    for key in ("t_compute", "t_memory", "t_collective", "flops_global", "bytes_global"):
        assert np.isfinite(rec[key]) and rec[key] > 0, (key, rec[key])
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert held["state"] == pytest.approx(info["state_bytes_per_device"], rel=1e-12)
    if "cache_bytes_per_device" in info:
        assert held["cache"] == pytest.approx(info["cache_bytes_per_device"], rel=1e-12)
    assert sum(got["colls"].values()) > 0


def test_one_by_one_mesh_records_no_collective(runs):
    got = runs["smoke"][(*ONE_BY_ONE, (1, 1))]
    assert all(abs(c) < 1e-9 for c in got["colls"].values()), got["colls"]
    assert got["rec"]["t_collective"] == 0.0
    assert got["held"]["state"] == pytest.approx(got["info"]["state_bytes_per_device"])


def _nonzero(rows):
    return {k: v for k, v in rows.items()
            if any(abs(x) > 1e-9 for x in (v if isinstance(v, list) else [v]))}


@pytest.mark.parametrize("name", [c[0] for cases in STENCIL_CASES for c in cases])
def test_stencils_equal_the_full_run(name, runs):
    """``measure``'s sum of its stencils' runs equals the step at full size:
    each op's calls and bytes (over its shapes: a stacked or sequence-long
    operand is another shape at each size), each collective's calls and
    bytes by group, the probe's FLOPs and the held bytes."""
    got = runs["stencil"][name]
    assert max(got["runs"]) > 1, got["runs"]      # the case extrapolates
    sten, full = got["stencil"], got["full"]
    ops, want_ops = _nonzero(sten["ops"]), _nonzero(full["ops"])
    assert set(ops) == set(want_ops)
    for op, row in want_ops.items():
        assert ops[op] == pytest.approx(row, rel=1e-12), op
    colls, want_colls = _nonzero(sten["colls"]), _nonzero(full["colls"])
    assert colls == pytest.approx(want_colls, rel=1e-12) and want_colls
    assert sten["bytes"] == pytest.approx(full["bytes"], rel=1e-12)
    assert sten["flops"] == pytest.approx(full["flops"], rel=1e-12) and full["flops"] > 0
    assert sten["held"] == pytest.approx(full["held"], rel=1e-12)
