"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface, loaded through
``ctypes``.  All sources compile at once, one ``nvcc`` process each, at
first use, into ``build/kernels/<hash>/`` under the repository root; the
hash covers the sources and the flags, so an edited source rebuilds and
an unchanged checkout reuses its libraries.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

KERNELS = ("sumtree_sample", "gather", "sample_gather", "sumtree_update",
           "flash_attention_fwd", "flash_attention_fwd_sm90", "flash_attention_dq",
           "flash_attention_dkv", "flash_attention_dq_sm90", "flash_attention_dkv_sm90")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel, counted by its wrapper right after a launch
# that the runtime accepted (and nowhere else)
launch_counts: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_log(name: str) -> str:
    """The compiler's output of kernel ``name``'s build: ptxas's registers,
    spills and warnings for each kernel instance (``-Xptxas -v``)."""
    path = build_dir() / f"lib{name}.log"
    return path.read_text() if path.exists() else ""


def build_all() -> float:
    """Compile every kernel that is not built yet, all ``nvcc`` processes
    started together; returns the seconds spent.  Raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    out = build_dir()
    todo = [k for k in KERNELS if not _lib_path(k).exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = out / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
        else:
            (out / f"lib{name}.log").write_text(log)
            os.replace(tmp, _lib_path(name))   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not _lib_path(name).exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for the launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def level_offsets(spec) -> ctypes.Array:
    """The spec's level offsets, then the end of the leaf level, as a C
    ``long long`` array."""
    offs = spec.offsets + (spec.total_size - 1,)
    return (ctypes.c_longlong * len(offs))(*offs)


def check(rc: int, name: str, launches: int = 1) -> None:
    """Raise on a refused launch; count the ``launches`` made otherwise."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    launch_counts[name] += launches
