"""Suggestions' time to first token, median: due (open loop) or send
(closed loop) to the first streamed delta; a miss is +inf."""

from perfbench.stats import percentile


def read(run):
    v = run.ttft_ms()
    return percentile(v, 50) if v else None
