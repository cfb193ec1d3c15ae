# ruff: noqa
"""Known-bad host-sync fixtures for the port's lint.  ``step`` (with the
host-side input ``env_steps``) and ``serve`` are the step programs: the
test passes them to ``retrace.sync_sites`` as its roots.

R401: a Python branch on a tensor-valued name.
R404: a call that copies a tensor to the host, or waits for the device.
"""
import numpy as np
import torch


def step(state, batch, lr: float):
    loss = torch.mean(batch["reward"])
    if loss > 0:                                    # R401
        lr = lr * 0.5
    warm = state.env_steps > 100 and bool(loss)     # R404: bool() of a tensor
    cur = loss.item()                               # R404
    batch["clock"][0] = state.env_steps             # R404: a host number copied in
    return _helper(batch["td"], lr), warm, cur


def _helper(td, lr):
    keep = td.abs() > 1e-3
    assert keep.any()                               # R401, in a def the program calls
    rows = torch.nonzero(keep)                      # R404: its size depends on the data
    td[0] = 0.0                                     # R404: a host number copied in
    return rows, td.cpu()                           # R404


def serve(engine, prompt: np.ndarray, slot: int, on: bool):
    tokens = torch.from_numpy(prompt).to("cuda")    # R404: a host-to-device copy
    active = torch.zeros(4, dtype=torch.bool, device="cuda")
    active[slot] = on                               # R404: a host bool copied in
    torch.cuda.synchronize()                        # R404
    return engine(tokens)
