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

from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather as _gather
from repro_torch.kernels import sample_gather as _sg
from repro_torch.kernels import sumtree_sample as _sample
from repro_torch.kernels import sumtree_update as _update
from repro_torch.kernels._build import (KERNELS, build_all,  # noqa: F401
                                        launch_counts, reset_launch_counts)

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
    """Batched priority SET, in place; duplicates resolve last-writer-wins.
    The plain version skips its mask for ``unique=True`` (caller-guaranteed
    distinct indices); the kernel dedups inside its launch either way."""
    if _on_cpu(tree):
        return _update.sumtree_update_plain(spec, tree, idx, values,
                                            unique=unique)
    return _update.sumtree_update_cuda(spec, tree, idx, values)


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


def gather_items(storage: Storage, idx: torch.Tensor) -> Storage:
    """{k: storage[k][idx]} for every leaf (at most 16), in one launch."""
    if all(_on_cpu(buf) for buf in storage.values()) and _on_cpu(idx):
        return _gather.gather_items_plain(storage, idx)
    return _gather.gather_items_cuda(storage, idx)


def flash_attention_nhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention: str = "full", window: int = 0,
                         causal: bool = True, is_global: bool = True) -> torch.Tensor:
    """Fused attention on (N, S, hd) tensors (N = batch·heads) → O,
    differentiable in q, k and v through the dQ and dK/dV kernels."""
    return _flash.FlashAttention.apply(q, k, v, attention, window, causal,
                                       is_global)
