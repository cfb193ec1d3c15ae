"""Flow control between decoupled writers and samplers (DESIGN.md §11) —
a copy of ``repro.service.rate_limiter`` (pure Python).

The fused loop couples actors and learners through ``RatioSchedule``:
``update_interval`` realizes an *implicit* samples-per-insert ratio

    spi = batch_size · learns / (period · n_envs · steps)
        = batch_size / update_interval

by construction — both sides run in one program, so the ratio can never
drift.  Once actors and learners are separate processes the coupling has
to become *explicit*: the ``RateLimiter`` tracks cumulative inserts ``i``
and samples ``s`` and keeps the signed sample debt

    D = (i − min_size_to_sample) · spi − s

inside ``±error_buffer``.  Writers are back-pressured (an insert of
``b`` items blocks while ``D + b·spi > error_buffer`` — actors may not
run so far ahead that items churn out of the buffer unsampled) and
samplers block (a sample of ``b`` blocks while ``i < min_size_to_sample``
or ``D − b < −error_buffer`` — learners may not consume the same
experience more often than the configured ratio allows).  Equivalently
the realized ratio ``s / (i − min_size_to_sample)`` is pinned to

    spi − error_buffer/(i − min) ≤ realized ≤ spi + error_buffer/(i − min)

i.e. explicit *min/max samples-per-insert* bounds that tighten as the
run progresses.  ``min_size_to_sample`` generalizes the loop's
``warmup_steps``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class ServiceStopped(Exception):
    """Raised by blocking admissions after ``stop()`` — the shutdown path
    for writers parked in backpressure when the learner finishes."""


class RateLimiter:
    def __init__(self, samples_per_insert: float, min_size_to_sample: int,
                 error_buffer: float):
        if samples_per_insert <= 0:
            raise ValueError(
                f"samples_per_insert={samples_per_insert}: must be > 0")
        if min_size_to_sample < 1:
            raise ValueError(
                f"min_size_to_sample={min_size_to_sample}: must be ≥ 1")
        if error_buffer < samples_per_insert:
            # a buffer tighter than one insert's worth of credit can
            # wedge both sides before steady state is ever reached
            raise ValueError(
                f"error_buffer={error_buffer}: must be ≥ samples_per_insert "
                f"({samples_per_insert}) or the limiter can deadlock")
        self.samples_per_insert = float(samples_per_insert)
        self.min_size_to_sample = int(min_size_to_sample)
        self.error_buffer = float(error_buffer)
        self._cond = threading.Condition()
        self._inserts = 0
        self._samples = 0
        self._stopped = False

    @classmethod
    def for_loop(cls, batch_size: int, update_interval: int,
                 warmup_steps: int, insert_burst: int = 1) -> "RateLimiter":
        """The limiter equivalent of ``RatioSchedule``: one ``batch_size``
        sample per ``update_interval`` env steps after ``warmup_steps``.
        ``insert_burst`` is the writer's append granularity (a gang actor
        appends a whole rollout chunk at once); the band must absorb one
        full burst's sample credit on top of a batch of debt or steady
        state wedges."""
        spi = batch_size / max(1, update_interval)
        return cls(samples_per_insert=spi,
                   min_size_to_sample=max(1, warmup_steps),
                   error_buffer=2.0 * max(batch_size, spi * insert_burst))

    @classmethod
    def from_schedule(cls, schedule, batch_size: int,
                      warmup_steps: int) -> "RateLimiter":
        """The *exact* limiter form of a ``RatioSchedule``: with
        ``error_buffer = learns · batch`` (the per-event sample quota) a
        greedy sampler drain admits exactly ``schedule.learns`` batches
        every ``schedule.period`` windows — the flow-control band is
        tight enough that the schedule's cadence is the only admissible
        trajectory (the ServiceExecutor equivalence contract,
        DESIGN.md §11)."""
        spi = (schedule.learns * batch_size
               / (schedule.period * schedule.env_steps_per_iter))
        return cls(samples_per_insert=spi,
                   min_size_to_sample=max(1, warmup_steps),
                   error_buffer=float(schedule.learns * batch_size))

    # -- accounting ---------------------------------------------------------

    # The three predicates below read the guarded counters without taking
    # self._cond themselves: every caller already holds it — the public
    # queries lock explicitly, and the await_* lambdas are evaluated
    # inside _await's `with self._cond:` loop.  Taking the (non-reentrant)
    # Condition here would deadlock.

    def _debt(self) -> float:  # repro-lint: disable=L301(callers hold self._cond)
        return ((self._inserts - self.min_size_to_sample)
                * self.samples_per_insert - self._samples)

    def _insert_ok(self, batch: int) -> bool:
        return (self._debt() + batch * self.samples_per_insert
                <= self.error_buffer)

    def _sample_ok(self, batch: int) -> bool:  # repro-lint: disable=L301(callers hold self._cond)
        return (self._inserts >= self.min_size_to_sample
                and self._debt() - batch >= -self.error_buffer)

    # -- non-blocking queries (host-driven executors poll these) ------------

    def can_insert(self, batch: int) -> bool:
        with self._cond:
            return self._insert_ok(batch)

    def can_sample(self, batch: int) -> bool:
        with self._cond:
            return self._sample_ok(batch)

    def note_insert(self, batch: int) -> None:
        with self._cond:
            self._inserts += batch
            self._cond.notify_all()

    def note_sample(self, batch: int) -> None:
        with self._cond:
            self._samples += batch
            self._cond.notify_all()

    # -- blocking admissions (service request threads) ----------------------

    def await_insert(self, batch: int,
                     timeout: Optional[float] = None) -> None:
        """Block until an insert of ``batch`` is admitted, then count it."""
        self._await(lambda: self._insert_ok(batch), timeout, "insert")
        with self._cond:
            self._inserts += batch
            self._cond.notify_all()

    def await_sample(self, batch: int,
                     timeout: Optional[float] = None) -> None:
        """Block until a sample of ``batch`` is admitted, then count it."""
        self._await(lambda: self._sample_ok(batch), timeout, "sample")
        with self._cond:
            self._samples += batch
            self._cond.notify_all()

    def _await(self, ok, timeout: Optional[float], what: str) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._stopped:
                    raise ServiceStopped(f"{what} admission after stop()")
                if ok():
                    return
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise TimeoutError(
                        f"rate limiter: {what} not admitted within "
                        f"{timeout:.1f}s (inserts={self._inserts}, "
                        f"samples={self._samples}, debt={self._debt():.1f}, "
                        f"error_buffer={self.error_buffer:.1f})")
                self._cond.wait(wait)

    def stop(self) -> None:
        """Wake every parked waiter with ``ServiceStopped`` — writers in
        backpressure must not hang when the learner finishes first."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    @property
    def stopped(self) -> bool:
        with self._cond:
            return self._stopped

    def restore_counts(self, inserts: int, samples: int) -> None:
        """Reset the debt counters to a snapshot's values (server
        restart, DESIGN.md §14) — the flow-control band resumes exactly
        where the crashed server left it instead of re-running warmup."""
        if inserts < 0 or samples < 0:
            raise ValueError(f"restore_counts({inserts}, {samples}): "
                             f"counts must be ≥ 0")
        with self._cond:
            self._inserts = int(inserts)
            self._samples = int(samples)
            self._cond.notify_all()

    # -- stats --------------------------------------------------------------

    @property
    def inserts(self) -> int:
        with self._cond:
            return self._inserts

    @property
    def samples(self) -> int:
        with self._cond:
            return self._samples

    def realized_samples_per_insert(self) -> float:
        """Realized ratio past warmup — the quantity the configured
        ``samples_per_insert`` bounds to within ±error_buffer/(i−min)."""
        with self._cond:
            denom = self._inserts - self.min_size_to_sample
            return self._samples / denom if denom > 0 else 0.0

    def stats(self) -> dict:
        with self._cond:
            denom = self._inserts - self.min_size_to_sample
            return {
                "inserts": self._inserts,
                "samples": self._samples,
                "samples_per_insert": self.samples_per_insert,
                "realized_spi": self._samples / denom if denom > 0 else 0.0,
                "error_buffer": self.error_buffer,
                "min_size_to_sample": self.min_size_to_sample,
                "stopped": self._stopped,
            }
