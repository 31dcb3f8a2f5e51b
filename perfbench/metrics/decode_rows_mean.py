"""Rows a decode step served: tokens decoded in the window (every
streamed token but each request's first, which its prefill samples)
over the decode steps the scheduler counted in the window
(``decode_fused_mean_k`` × ``serve_decode_ticks_total``; speculation is
off)."""


def _steps(snap):
    return snap["decode_fused_mean_k"] * snap["serve_decode_ticks_total"]


def read(run):
    steps = _steps(run.counters["close"]) - _steps(run.counters["open"])
    tokens = 0
    for r in run.records:
        for i, (t, d) in enumerate(r.deltas):
            if run.t_open <= t < run.t_close:
                tokens += len(d) - (i == 0)
    return tokens / steps if steps > 0 else None
