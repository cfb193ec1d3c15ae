# ruff: noqa
"""Suppression-mechanics fixtures for the port's lint.

Expected findings, with ``step`` the step program the test names:
exactly one X001 (empty reason), its R404 left alive, and one X001 for a
repro-lint comment that is not a disable.  Everything else is waived
with a justification.
"""
import torch


def step(x):
    # repro-lint: disable=R404(read once for the log line; the next item removes it)
    a = x.item()
    b = x.tolist()  # repro-lint: disable=R404()
    return a, b, _waived(x)


def _waived(x):  # repro-lint: disable=R401(a def-line waiver covers the body)
    if x.sum() > 0:
        return x
    return -x


# repro-lint: enable=R404
