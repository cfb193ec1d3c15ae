"""Elastic restart for the process model — the port's counterpart of
``repro.checkpoint.elastic.reshard``.

The learner state (params, target, Adam count and moments, step, an
agent's ``extra``) is replicated on every rank of a mesh, so a checkpoint
holds it once and restarts at any world size: ``save_learner`` writes it
from rank 0, ``restore_learner`` has rank 0 read it and broadcasts it to
every rank, in place.  A job checkpointed at world D restarts at world D′.
Per-shard state — the replay shard, the acting copy, the EF buffer — is
not carried over and re-initializes, as the reference's policy says:
actor shards refill the replay buffer, learner state resumes exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.agents.base import generator_names, load_generators, state_tensors
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.collectives import broadcast_


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save_learner(mgr: CheckpointManager, step: int, agent_state) -> Optional[str]:
    """Rank 0 writes the replicated learner state; returns the committed
    path there, None on the other ranks."""
    if _rank() != 0:
        return None
    return mgr.save(step, state_tensors(agent_state))


def restore_learner(mgr: CheckpointManager, agent_state, step: Optional[int] = None
                    ) -> Optional[int]:
    """Rank 0 restores ``step`` (default: the newest committed one) into
    ``agent_state``'s tensors and broadcasts them to every rank, in place;
    each rank's learn generators are set from rank 0's checkpointed
    states.  Returns the step on every rank, None (nothing changed) when
    rank 0 finds no checkpoint."""
    tensors = state_tensors(agent_state)
    device = agent_state.step.device
    if _rank() == 0:
        if step is None:
            steps = mgr.all_steps()
            step = steps[-1] if steps else None
        if step is not None:
            mgr.restore(step, tensors)
    if dist.is_initialized():
        found = torch.full((), -1 if step is None else step, dtype=torch.int64, device=device)
        dist.broadcast(found, src=0)
        step = int(found) if int(found) >= 0 else None
    if step is None:
        return None
    gens = generator_names(agent_state)
    if dist.is_initialized():
        # generator states are host tensors; NCCL carries only device ones
        moved = {k: t.to(device) if k in gens else t for k, t in tensors.items()}
        broadcast_(list(moved.values()))
        tensors.update({k: moved[k].cpu() for k in gens})
    load_generators(agent_state, tensors)
    return step
