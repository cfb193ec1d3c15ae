# ruff: noqa
"""Known-good in-place fixtures: rebinding, a clone taken before the
call, reads of other fields, and calls that only share a name with an
in-place function."""


def chunk(ex, state, n):
    state, metrics = ex.run_chunk(state, n)
    return state.replay.count, metrics      # the rebound state


def keep_old(replay, state):
    old = state.clone()
    state = replay.flush(state)
    return old.tree[0], state.tree[0]       # the clone keeps the old tree


def clock(ex, state, n):
    new_state, _ = ex.run_chunk(state, n)
    return new_state, state.env_steps       # only state.replay is updated


def shards(replay, states):
    states = [replay.flush(s) for s in states]
    return [s.count for s in states]


def lists(items, x):
    items.append(x)                         # list.append: one argument
    items.insert(0, x)
    return items, x
