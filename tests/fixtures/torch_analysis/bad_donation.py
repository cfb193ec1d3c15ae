# ruff: noqa
"""Known-bad in-place fixtures for the port's lint.

D101: a read of a binding after a function of the in-place table updated
it, before the binding is rebound.
"""


def chunk(ex, state, n):
    new_state, metrics = ex.run_chunk(state, n)
    leftover = state.replay.count           # D101: run_chunk updated state.replay
    return new_state, metrics, leftover


def flush_then_read(replay, state):
    fresh = replay.flush(state)
    return fresh, state.tree[0]             # D101: the old binding is the new tree


def learn_loop(replay, state, idx, td, k):
    for _ in range(k):
        peek = state.max_priority           # D101: read again after the next update
        replay.update_priorities(state, idx, td, lazy=True)
    return peek


def decode(engine, params, state):
    actions, new = engine.step(params, state)
    return actions, new, state.cache        # D101: the one live cache was written
