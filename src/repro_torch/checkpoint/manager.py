"""Fault-tolerant checkpointing — port of ``repro.checkpoint.manager``:
atomic-rename npz + manifest.

  * a checkpoint directory is staged as ``step_<n>.tmp`` and committed by
    a single atomic ``rename``: a crash mid-save never corrupts the latest
    valid checkpoint, and an uncommitted ``.tmp`` is invisible;
  * ``save_async`` snapshots to host memory at once and writes in a
    background thread, so the train loop does not wait on the disk;
  * ``restore`` checks the manifest's keys against the example (and each
    shape and dtype) and copies the saved values into the example's tensors, one at
    a time, so that restoring a state makes no second copy of it;
    ``restore_latest`` takes the newest committed step;
  * keep-last-k GC bounds disk usage; ``extra=`` byte blobs commit inside
    the same rename and read back with ``read_extra``.

What is saved is a flat dict of named tensors (``agents.base.
state_tensors`` gives an ``AgentState``'s or a ``TrainState``'s).  bf16 has no numpy dtype here,
so a bf16 tensor is stored as its uint16 bit pattern with ``"bfloat16"``
in the manifest, and restored bit for bit.  ``checkpoint/elastic.py``
restores a replicated learner state at another world size.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
_SEP = "/"
_RESERVED = ("arrays.npz", "manifest.json")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """→ (host array, manifest dtype name)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _dtype_name(t: torch.Tensor) -> str:
    """The manifest's name of ``t``'s dtype (numpy's, and ``"bfloat16"``)."""
    return str(t.dtype).removeprefix("torch.")


def _from_numpy(raw: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(raw)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tensors: Tensors,
             extra: Optional[Dict[str, bytes]] = None) -> str:
        """Synchronous atomic save; returns the committed path.  ``extra``
        maps file names to byte blobs committed in the same rename."""
        return self._write(step, self._snapshot(tensors), extra)

    def save_async(self, step: int, tensors: Tensors) -> None:
        """Snapshot to host now, write in the background (the previous
        write is joined first: at most one outstanding save)."""
        self.wait()
        host = self._snapshot(tensors)
        self._thread = threading.Thread(target=self._write, args=(step, host))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _snapshot(tensors: Tensors) -> Dict[str, Tuple[np.ndarray, str]]:
        return {k: _to_numpy(t) for k, t in tensors.items()}

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
               extra: Optional[Dict[str, bytes]] = None) -> str:
        for name in extra or {}:
            if name in _RESERVED or _SEP in name:
                raise ValueError(f"extra blob name {name!r}: reserved or contains a "
                                 f"path separator")
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{k: a for k, (a, _) in host.items()})
        manifest = {
            "step": step,
            "keys": sorted(host),
            "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
            "dtypes": {k: dt for k, (_, dt) in host.items()},
            "extra": sorted(extra) if extra else [],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        for name, blob in (extra or {}).items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(blob)
        if os.path.exists(final):
            # re-saving an existing step (a restart at the same point):
            # retire the old commit first, since rename over a non-empty
            # directory fails on POSIX
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, example: Tensors) -> Tensors:
        """The tensors of ``step`` copied into ``example``'s tensors (on
        their device), which are returned.  Each example tensor must have
        the saved shape and dtype: a cast would not restore bit for bit."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if sorted(example) != manifest["keys"]:
            diff = set(manifest["keys"]) ^ set(example)
            raise ValueError(f"manifest/tensors mismatch: {sorted(diff)[:5]} ...")
        with np.load(os.path.join(path, "arrays.npz")) as data, torch.no_grad():
            for key, ex in example.items():
                if list(ex.shape) != manifest["shapes"][key]:
                    raise ValueError(f"{key}: checkpoint shape {manifest['shapes'][key]}, "
                                     f"example {list(ex.shape)}")
                if _dtype_name(ex) != manifest["dtypes"][key]:
                    raise ValueError(f"{key}: checkpoint dtype {manifest['dtypes'][key]}, "
                                     f"example {_dtype_name(ex)}")
                ex.copy_(_from_numpy(data[key], manifest["dtypes"][key]))
        return example

    def restore_latest(self, example: Tensors) -> Tuple[Optional[int], Tensors]:
        steps = self.all_steps()
        if not steps:
            return None, example
        return steps[-1], self.restore(steps[-1], example)

    def read_extra(self, step: int, name: str) -> Optional[bytes]:
        """One ``extra`` blob of a committed step; None when the step has
        no blob by that name."""
        path = os.path.join(self.dir, f"step_{step}", name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()
