"""Device selection shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
CUDA device and no explicit ``"cpu"`` they raise instead of quietly
running on the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device (raises without
    one); ``"cpu"`` → the CPU.  Other device types are refused."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
