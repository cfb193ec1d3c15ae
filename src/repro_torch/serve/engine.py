"""Device math of the continuous-batching actor server — port of
``repro.serve.engine`` (DESIGN.md §13).

The reference vmaps a batch-of-1 ``token_dqn.serve_step`` over the slot
axis so that each slot's cache carries its own scalar ``pos``.  Here the
batched cache keeps a position vector, one entry per slot, and the
decode takes every slot's RoPE phase, cache write and causal mask from
its own entry: one batched decode over the slot table, free slots frozen
by the slot mask.

* ``prime``  — bucket-padded prefill of one request into a fresh slot
               cache, ``pos`` rewound to the true prompt length, the
               first greedy token taken at the last real position.
               ``prime_compiles`` counts the distinct padded shapes run
               (the reference's retrace count), bounded by the bucket set.
* ``insert``/``release`` — slot-table edits, in place.
* ``step``   — the decode over all slots, in place: serving holds one
               live KV cache.

On a mesh (``shd`` and a ``device_mesh``; the parameters cut by
``launch/sharded.py::shard_params``) the slot cache is placed by
``cache_specs`` (slots over the data axes, the sequence or the KV heads
over the model axis), ``insert`` writes a slot on the ranks that hold it,
and the actions come back whole: every rank takes the same admission and
release decisions and gets the same answers.

Families: dense | moe, as the reference's.  Pad-then-rewind needs state
that is purely position-indexed; vlm prompts carry patch embeddings the
request queue does not model.  A moe prefill routes its padded bucket in
one call, the pad after the real tokens, as the reference's; the batched
decode routes without a capacity, so each slot gets what the
reference's per-slot call gives it (``models/moe.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Set, Tuple

import numpy as np
import torch

from repro_torch.agents import token_dqn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import backbone
from repro_torch.models import layers as L
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig
from repro_torch.serve.buckets import BucketSpec

SUPPORTED_FAMILIES = ("dense", "moe")


class DecodeState(NamedTuple):
    """Per-slot serving state: the batched slot cache (batch axis =
    slot, ``pos`` (slots,)), each slot's next input token, and the busy
    mask."""

    cache: backbone.Cache
    tokens: torch.Tensor          # (slots, 1) int64
    active: torch.Tensor          # (slots,) bool


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, shd: ShardingConfig = NO_SHARDING, *, slots: int,
                 max_len: int, buckets: BucketSpec, device: DeviceLike = "cuda",
                 device_mesh=None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(
                f"DecodeEngine serves {SUPPORTED_FAMILIES} families only, "
                f"got {cfg.family!r} ({cfg.name}): pad-then-rewind needs a "
                "purely position-indexed cache (DESIGN.md §13)")
        if slots < 1:
            raise ValueError(f"slots={slots}: must be >= 1")
        if buckets.max_prompt_len > max_len:
            raise ValueError(
                f"largest bucket edge {buckets.max_prompt_len} exceeds "
                f"max_len={max_len}: prefill could not fit in the cache")
        if shd.enabled and device_mesh is None:
            raise ValueError("a sharded DecodeEngine needs the parameters' device_mesh")
        self.cfg = cfg
        self.shd = shd
        self.device_mesh = device_mesh if shd.enabled else None
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.buckets = buckets
        self.device = resolve_device(device)
        self._prime_shapes: Set[Tuple[int, ...]] = set()
        self._decode_shapes: Set[Tuple[int, ...]] = set()

    # -- state ---------------------------------------------------------------

    def init_state(self) -> DecodeState:
        return DecodeState(
            cache=backbone.init_cache(self.cfg, self.slots, self.max_len,
                                      device=self.device, shd=self.shd,
                                      device_mesh=self.device_mesh),
            tokens=torch.zeros((self.slots, 1), dtype=torch.int64, device=self.device),
            active=torch.zeros((self.slots,), dtype=torch.bool, device=self.device))

    def fits(self, prompt_len: int, max_new_tokens: int) -> None:
        """Admission-time capacity check (raises on violation): the
        prompt must land in a bucket and the last decode write at
        ``prompt_len + max_new_tokens - 2`` must stay inside the cache."""
        self.buckets.bucket_for(prompt_len)   # raises past the last edge
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}: must be >= 1")
        if prompt_len + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt_len={prompt_len} + max_new_tokens={max_new_tokens} "
                f"- 1 exceeds max_len={self.max_len}: the generation would "
                "overrun the KV cache")

    # -- ops -----------------------------------------------------------------

    @torch.no_grad()
    def prime(self, params: backbone.Backbone, prompt: np.ndarray
              ) -> Tuple[torch.Tensor, backbone.Cache]:
        """Bucket-padded prefill of one prompt → (first greedy token,
        slot cache with pos = true length).  The pad keys sit at
        positions >= pos and are overwritten by real decode keys before
        the causal mask can see them."""
        prompt = np.asarray(prompt, np.int32)
        # repro-lint: disable=R404(the prompt's tokens arrive on the host; ROADMAP held work B, the decode dispatch, stages them without a wait)
        padded = torch.from_numpy(self.buckets.pad(prompt)).to(self.device, torch.int64)
        self._prime_shapes.add(tuple(padded.shape))
        logits, cache = backbone.prefill(self.cfg, params, padded, max_len=self.max_len,
                                         shd=self.shd)
        true_len = prompt.shape[0]
        off = logits.shape[1] - padded.shape[1]
        last = L.shard(logits[0, off + true_len - 1], self.shd, None)   # the whole vocabulary
        tok = torch.argmax(L.local(last), dim=-1)
        L.local(cache["pos"]).fill_(true_len)
        return tok, cache

    @torch.no_grad()
    def insert(self, state: DecodeState, slot: int, slot_cache: backbone.Cache,
               tok: torch.Tensor) -> DecodeState:
        for name in ("k", "v"):
            backbone.write_slot(state.cache[name], slot, slot_cache[name])
        L.local(state.cache["pos"])[slot] = L.local(slot_cache["pos"])[0]
        state.tokens[slot, 0] = tok
        # repro-lint: disable=R404(the busy flag is a host bool copied to the card; ROADMAP held work B, the decode dispatch)
        state.active[slot] = True
        return state

    def release(self, state: DecodeState, slot: int) -> DecodeState:
        # repro-lint: disable=R404(the busy flag is a host bool copied to the card; ROADMAP held work B, the decode dispatch)
        state.active[slot] = False
        return state

    @torch.no_grad()
    def step(self, params: backbone.Backbone, state: DecodeState
             ) -> Tuple[torch.Tensor, DecodeState]:
        """One continuous-batching decode step over every slot; free
        slots are frozen in place by the slot mask."""
        self._decode_shapes.add(tuple(state.tokens.shape))
        actions, cache = token_dqn.serve_step(self.cfg, params, state.cache,
                                              state.tokens, state.active, self.shd)
        state = DecodeState(cache=cache, tokens=actions.reshape(self.slots, 1),
                            active=state.active)
        return actions, state

    # -- shape accounting -----------------------------------------------------

    @property
    def prime_compiles(self) -> int:
        """Distinct padded prefill shapes run: bounded by
        ``len(buckets.edges)`` (the reference's retrace count)."""
        return len(self._prime_shapes)

    @property
    def decode_compiles(self) -> int:
        return len(self._decode_shapes)
