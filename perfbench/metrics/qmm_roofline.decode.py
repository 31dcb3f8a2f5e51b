"""Kernels A and C in decode ticks: the least time of each launch
(perfbench/kernels.py) over the device time of the launches and their
split-K reduces, inside ``sched.tick`` ranges."""

from perfbench.kernels import roofline_pct


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run.trace, run.model, ("tick",), run.slots)
