"""Public wrappers of the CUDA kernels — port of ``repro.kernels.ops``.

Each wrapper takes the kernel's plain PyTorch version for a tensor on
the CPU, and only then.  For a CUDA tensor it launches the kernel or
raises: there is no fallback.  The kernels read the tree's flat layout
directly (level offsets come from the spec), so the TPU wrappers'
level-matrix copies, batch/storage padding and VMEM-budget fallback have
no counterpart here.  ``launch_counts`` counts the launches of each
kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import sumtree
from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.kernels import gather as _gather
from repro_torch.kernels import sample_gather as _sg
from repro_torch.kernels import sumtree_sample as _sample
from repro_torch.kernels import sumtree_update as _update
from repro_torch.kernels._build import (build_all, launch_counts,  # noqa: F401
                                        reset_launch_counts)

Storage = Dict[str, torch.Tensor]


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def sumtree_sample(spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched inverse-CDF sample → (idx int64, priority)."""
    if _on_cpu(tree):
        return _sample.sumtree_sample_plain(spec, tree, u)
    return _sample.sumtree_sample_cuda(spec, tree, u)


def sumtree_update(spec: SumTreeSpec, tree: torch.Tensor, idx: torch.Tensor,
                   values: torch.Tensor, unique: bool = False) -> torch.Tensor:
    """Batched priority SET, in place.  Duplicates resolve
    last-writer-wins through the mask computed here; ``unique=True``
    skips it for caller-guaranteed distinct indices."""
    if _on_cpu(tree):
        return _update.sumtree_update_plain(spec, tree, idx, values,
                                            unique=unique)
    mask = None if unique else sumtree.last_writer_mask(idx, spec.num_leaves)
    return _update.sumtree_update_cuda(spec, tree, idx, values, mask)


def sumtree_sample_gather(spec: SumTreeSpec, tree: torch.Tensor,
                          u: torch.Tensor, storage: Storage
                          ) -> Tuple[torch.Tensor, torch.Tensor, Storage]:
    """Fused descent + storage fetch → (idx, priority, rows per leaf)."""
    if _on_cpu(tree):
        return _sg.sample_gather_plain(spec, tree, u, storage)
    return _sg.sample_gather_cuda(spec, tree, u, storage)


def prioritized_gather(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = storage[idx[i]], any-rank storage (leading index dim)."""
    if _on_cpu(storage):
        return _gather.gather_plain(storage, idx)
    return _gather.gather_cuda(storage, idx)
