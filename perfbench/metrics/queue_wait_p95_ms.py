"""The scheduler's ``sched.queue_wait`` spans (arrival to the admission
dispatch) of every request counted in the window, 95th percentile."""

from perfbench.stats import percentile


def read(run):
    waits = [s["dur_ms"] for r in run.counted()
             for s in run.spans.get(r.trace_id, ())
             if s["name"] == "sched.queue_wait"]
    return percentile(waits, 95) if waits else None
