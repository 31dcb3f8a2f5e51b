"""Gaps between successive streamed deltas, pooled over every request
counted in the window, 95th percentile. A fused tick delivers several
tokens in one delta: the gap users see is what is counted."""

from perfbench.stats import percentile


def read(run):
    gaps = [(b[0] - a[0]) * 1e3 for r in run.counted()
            for a, b in zip(r.deltas, r.deltas[1:])]
    return percentile(gaps, 95) if gaps else None
