"""Token MDP — port of ``repro.envs.token_mdp``, the LM-scale environment.

State = current token; action = predicted next token; the environment
advances by sampling from a fixed random Markov chain over the vocab;
reward = 1 if the agent's action equals the sampled next token.  The
optimal policy is the argmax of the transition row, with known optimal
expected reward.

The transition table is (V, V) f32 logits, Gumbel noise over the
concentration, as the reference's: 34.3 GB at InternLM2's V = 92,544.
It is made in row blocks from a ``torch.Generator`` on the generator's
device.  ``step`` samples the next token by Gumbel-max (the reference's
``jax.random.categorical``); ``make`` and ``step`` take an explicit table
and explicit noise, so that a test can feed both sides the same numbers.
``optimal_reward`` is computed once, in row blocks, and cached: the
reference builds a second V² softmax on every call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

ROW_BLOCK = 4096      # rows of the table made or reduced at a time


@dataclasses.dataclass(frozen=True)
class TokenMDPSpec:
    vocab: int
    concentration: float = 0.3   # lower → peakier transitions (easier)


class TokenMDPState(NamedTuple):
    token: torch.Tensor   # (n,) int64 current tokens
    table: torch.Tensor   # (V, V) f32 transition logits (fixed per MDP instance)


def gumbel_(x: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Fill ``x`` (f32) with standard Gumbel noise, in place:
    ``-log(-log(u))``, u uniform in [tiny, 1), as ``jax.random.gumbel``."""
    x.uniform_(generator=gen).clamp_(min=torch.finfo(x.dtype).tiny)
    return x.log_().neg_().log_().neg_()


def make(spec: TokenMDPSpec, gen: torch.Generator, n_envs: int,
         table: Optional[torch.Tensor] = None
         ) -> Tuple[Callable, Callable, Callable[[], float]]:
    """→ ``(reset, step, optimal_reward)`` over one fixed table, made from
    ``gen`` on its device unless ``table`` is given."""
    if table is None:
        v = spec.vocab
        table = torch.empty((v, v), dtype=torch.float32, device=gen.device)
        for r in range(0, v, ROW_BLOCK):
            gumbel_(table[r:r + ROW_BLOCK], gen).div_(spec.concentration)
    cached = []

    def reset(gen: torch.Generator) -> Tuple[TokenMDPState, torch.Tensor]:
        tok = torch.randint(0, spec.vocab, (n_envs,), generator=gen, device=table.device)
        return TokenMDPState(tok, table), tok

    def step(state: TokenMDPState, actions: torch.Tensor,
             gen: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
        """→ (state', next tokens, reward f32, done bool).  ``noise`` (n, V)
        is the Gumbel noise of the draw; else it comes from ``gen``."""
        logits = state.table[state.token]                     # (n, V)
        if noise is None:
            noise = gumbel_(torch.empty_like(logits), gen)
        nxt = torch.argmax(logits + noise, dim=-1)
        reward = (actions == nxt).float()
        return TokenMDPState(nxt, state.table), nxt, reward, torch.zeros_like(reward, dtype=torch.bool)

    def optimal_reward() -> float:
        """E[max_a P(a|s)] under the uniform token distribution: the mean
        over rows of exp(max − logsumexp)."""
        if not cached:
            total = torch.zeros((), dtype=torch.float64, device=table.device)
            for r in range(0, table.shape[0], ROW_BLOCK):
                rows = table[r:r + ROW_BLOCK]
                top = torch.exp(rows.max(-1).values - torch.logsumexp(rows, -1))
                total += top.double().sum()
            cached.append(float(total) / table.shape[0])
        return cached[0]

    return reset, step, optimal_reward
