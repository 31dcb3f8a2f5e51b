"""Share of the traced slice in which no kernel, copy or set ran on the
device (the union of their intervals is the busy time)."""


def read(run):
    t = run.trace
    if t is None or not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
