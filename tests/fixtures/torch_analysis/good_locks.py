# ruff: noqa
"""Known-good lock-discipline fixtures."""
import threading


class Shard:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inserts = 0

    def append(self):
        with self._cond:
            self._inserts += 1
            self._cond.notify_all()

    def total(self):
        with self._lock:
            return self._inserts

    def wait_for(self, n):
        with self._cond:
            while self._inserts < n:
                self._cond.wait()
