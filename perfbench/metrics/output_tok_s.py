"""Tokens streamed inside the window (every request's, lead-in's too),
over the window's seconds. A served token is one printable character."""


def read(run):
    n = sum(len(d) for r in run.records for t, d in r.deltas
            if run.t_open <= t < run.t_close)
    return n / run.seconds
