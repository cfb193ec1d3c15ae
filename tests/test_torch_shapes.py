"""The dry run's input shapes (``repro_torch.configs.shapes``) against
``repro.configs.shapes``: the shape cases, which cells run, and every input
of every (arch, shape) cell, shapes and dtypes exactly, for all ten archs
and four shapes."""

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import shapes as jshp
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as shp

DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def test_shape_cases_match_reference():
    assert list(shp.SHAPES) == list(jshp.SHAPES)
    for name, case in shp.SHAPES.items():
        ref = jshp.SHAPES[name]
        assert (case.name, case.seq_len, case.global_batch, case.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)


def _same(got, want):
    assert list(got) == list(want)
    for key, (shape, dtype) in got.items():
        assert tuple(shape) == tuple(want[key].shape), key
        assert jnp.dtype(DTYPES[dtype]) == jnp.dtype(want[key].dtype), key


@pytest.mark.parametrize("shape", list(shp.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_inputs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    case, jcase = shp.SHAPES[shape], jshp.SHAPES[shape]
    assert shp.runnable(cfg, shape) == jshp.runnable(jcfg, shape)
    _same(shp.token_specs(cfg, case), jshp.token_specs(jcfg, jcase))
    _same(shp.learner_batch_specs(cfg, case), jshp.learner_batch_specs(jcfg, jcase))
    meta = shp.meta_tensors(shp.learner_batch_specs(cfg, case))
    assert all(t.device.type == "meta" for t in meta.values())
    assert {k: (tuple(t.shape), t.dtype) for k, t in meta.items()} == \
        shp.learner_batch_specs(cfg, case)
