# ruff: noqa
"""Known-bad lock-discipline fixtures for the port's lint (the
reference's rules, copied).

L301: guarded attribute touched without the lock.
L302: Condition.wait outside a predicate while-loop.
L303: notify on an unheld Condition.
"""
import threading


class Shard:
    def __init__(self):
        self._lock = threading.Lock()
        self._inserts = 0

    def append(self):
        with self._lock:
            self._inserts += 1

    def total(self):
        return self._inserts           # L301: no lock held


class Limiter:
    def __init__(self):
        self._cond = threading.Condition()
        self._debt = 0

    def note(self):
        with self._cond:
            self._debt += 1
        self._cond.notify_all()        # L303: lock already released

    def wait(self):
        with self._cond:
            if self._debt:
                self._cond.wait()      # L302: if, not while
