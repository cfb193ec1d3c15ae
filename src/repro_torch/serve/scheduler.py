"""Host-side continuous-batching scheduler — port of
``repro.serve.scheduler`` (DESIGN.md §13).

A FIFO request queue feeds a fixed table of decode slots.  Each
``serve_step`` call is one admission window + one batched decode step:

1. **admit** — every free slot pops the queue head, prefills it through
   the engine's bucket-padded ``prime`` and lands in the slot table
   (the request's first generated token comes from prefill);
2. **decode** — one batched decode step over the whole table (free
   slots frozen by the slot mask), one token appended per busy slot;
3. **evict** — slots that reached their generation budget emit a
   ``Completion`` and are released, so the *next* ``serve_step`` admits
   into them — continuous batching over the KV cache, no global drain.

The scheduler takes ``(params, params_version)`` **per call** and uses
that one pair for every prime and the decode step inside the window —
the single-version-per-batch-step half of the §13 param-publication
contract (the other half, swap-at-the-boundary, lives in
``serve/params.py``).  ``step_log`` records ``(step, version,
n_active)`` so tests can assert no step ever saw two versions.

Token accounting is exact by construction and asserted in tests:
``admissions + decoded_tokens == sum(len(c.tokens))`` over completions
plus in-flight slots — prefill contributes exactly one token per
admission, decode exactly one per busy slot per step.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import DecodeEngine

Pytree = Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    enqueued_at: float


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: List[int]             # generated tokens, len == max_new_tokens
    slot: int
    params_version: int           # the version of the step that finished it
    enqueued_at: float
    admitted_at: float
    finished_at: float

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.enqueued_at


@dataclasses.dataclass
class _Active:
    req: Request
    tokens: List[int]
    admitted_at: float


class Scheduler:
    def __init__(self, engine: DecodeEngine, *, log_len: int = 4096):
        self.engine = engine
        self.state = engine.init_state()
        self.queue: deque = deque()
        self._slots: List[Optional[_Active]] = [None] * engine.slots
        self._next_rid = 0
        # exact token/phase accounting (repro_torch.serve_actor reports
        # these; tests assert the closed-form invariant)
        self.step_count = 0
        self.admissions = 0
        self.decoded_tokens = 0
        self.timings: Dict[str, float] = {"prefill_s": 0.0, "decode_s": 0.0}
        self.step_log: deque = deque(maxlen=log_len)      # (step, version, n_active)
        self.admission_log: deque = deque(maxlen=log_len)  # (rid, slot, step)

    # -- queue ----------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               enqueued_at: Optional[float] = None) -> int:
        """Admission-checked enqueue; returns the request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.engine.fits(prompt.shape[0], max_new_tokens)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            enqueued_at=(time.perf_counter() if enqueued_at is None
                         else enqueued_at)))
        return rid

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(a is not None for a in self._slots)

    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self._slots)

    @property
    def generated_tokens(self) -> int:
        """Exact total: one per admission (prefill) + one per busy slot
        per decode step."""
        return self.admissions + self.decoded_tokens

    # -- the serve step -------------------------------------------------------

    def serve_step(self, params: Pytree,
                   params_version: int = 0) -> List[Completion]:
        """One admission window + one batched decode step under ONE
        (params, version) pair.  Returns the completions it evicted."""
        completions: List[Completion] = []

        t0 = time.perf_counter()
        for slot, occupant in enumerate(self._slots):
            if occupant is not None or not self.queue:
                continue
            req = self.queue.popleft()
            tok, slot_cache = self.engine.prime(params, req.prompt)
            first = int(tok)                       # host sync: prefill done
            self.state = self.engine.insert(self.state, slot, slot_cache, tok)
            now = time.perf_counter()
            self._slots[slot] = _Active(req, [first], admitted_at=now)
            self.admissions += 1
            self.admission_log.append((req.rid, slot, self.step_count))
        self.timings["prefill_s"] += time.perf_counter() - t0

        # a budget-1 request is already complete at admission
        for slot, a in enumerate(self._slots):
            if a is not None and len(a.tokens) >= a.req.max_new_tokens:
                completions.append(self._evict(slot, params_version))

        if not any(a is not None for a in self._slots):
            return completions

        t0 = time.perf_counter()
        actions, self.state = self.engine.step(params, self.state)
        acts = actions.tolist()                    # host sync: decode done
        self.timings["decode_s"] += time.perf_counter() - t0
        self.step_count += 1
        self.step_log.append((self.step_count, params_version, self.n_active))

        for slot, a in enumerate(self._slots):
            if a is None:
                continue
            a.tokens.append(int(acts[slot]))
            self.decoded_tokens += 1
            if len(a.tokens) >= a.req.max_new_tokens:
                completions.append(self._evict(slot, params_version))
        return completions

    def _evict(self, slot: int, params_version: int) -> Completion:
        a = self._slots[slot]
        assert a is not None
        self.state = self.engine.release(self.state, slot)
        self._slots[slot] = None
        return Completion(
            rid=a.req.rid,
            prompt_len=int(a.req.prompt.shape[0]),
            tokens=a.tokens,
            slot=slot,
            params_version=params_version,
            enqueued_at=a.req.enqueued_at,
            admitted_at=a.admitted_at,
            finished_at=time.perf_counter(),
        )
