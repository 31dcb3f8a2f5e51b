"""How late the harness's generator sent, against each request's due
time, 99th percentile over the requests counted in the window (a closed
loop's are due when sent)."""

import math

from perfbench.stats import percentile


def read(run):
    lag = [(r.send - r.due) * 1e3 for r in run.counted()
           if not math.isnan(r.send)]
    return percentile(lag, 99) if lag else None
