"""A torch.profiler capture of a slice of the window, read into device
events attributed to the scheduler's ``sched.<op>`` ranges.

The profiler starts and stops on the scheduler's loop thread (a job the
loop runs between iterations, as the program's live profiler server
does): a profiler started on another thread records none of the loop's
ranges. Each device event (kernel, copy, set) is attributed to the
innermost ``sched.<op>`` range that held its launch on the host, through
the launch's correlation id; a kernel replayed from a CUDA graph carries
the graph launch's. Busy time is the union of the device events'
intervals, the arithmetic of ``tools/trace_step.union_ms``.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import tempfile
from dataclasses import dataclass, field

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def merged(spans) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class DeviceEvent:
    name: str
    start: float           # us
    end: float
    grid: tuple
    op: str                # the sched.<op> range of its launch, or ""
    op_id: int             # which range (index into ranges), or -1


@dataclass
class Trace:
    window: tuple                          # (start us, end us)
    events: list                           # DeviceEvent
    ranges: list                           # (name, start us, end us, tid)
    shapes: dict = field(default_factory=dict)   # range index -> dims

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return union((e.start, e.end) for e in self.events) / 1e6

    def in_op(self, *ops: str) -> list:
        return [e for e in self.events if e.op in ops]


def _innermost(ranges_by_tid: dict, tid, ts: float) -> int:
    """Index of the innermost range on ``tid`` that holds ``ts``, or -1."""
    rs = ranges_by_tid.get(tid)
    if not rs:
        return -1
    starts = [r[1] for r in rs]
    i = bisect.bisect_right(starts, ts) - 1
    best = -1
    while i >= 0:
        _, a, b, idx = rs[i]
        if a <= ts <= b:
            best = idx            # later starts are nested deeper
            break
        i -= 1
    return best


def parse(doc: dict) -> Trace:
    """A Chrome trace as torch.profiler exports it."""
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = []
    launches = {}
    device = []
    mean_ops = []
    t_lo, t_hi = math.inf, -math.inf
    for e in evs:
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
        args = e.get("args", {})
        if cat == "user_annotation" and e["name"].startswith("sched."):
            ranges.append((e["name"][len("sched."):], ts, ts + dur,
                           e.get("tid")))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            if "correlation" in args:
                launches[args["correlation"]] = (ts, e.get("tid"))
        elif cat in _DEVICE_CATS:
            device.append(e)
        elif cat == "cpu_op" and e["name"] == "aten::mean":
            dims = args.get("Input Dims")
            if dims and len(dims[0]) == 3:
                mean_ops.append((ts, e.get("tid"), tuple(dims[0])))
    ranges.sort(key=lambda r: r[1])
    by_tid: dict = {}
    for i, (name, a, b, tid) in enumerate(ranges):
        by_tid.setdefault(tid, []).append((name, a, b, i))
    events = []
    for e in device:
        ts = float(e["ts"])
        args = e.get("args", {})
        launch = launches.get(args.get("correlation"))
        idx = -1 if launch is None else _innermost(by_tid, launch[1],
                                                    launch[0])
        events.append(DeviceEvent(
            name=e["name"], start=ts, end=ts + float(e.get("dur", 0)),
            grid=tuple(args.get("grid", ())),
            op=ranges[idx][0] if idx >= 0 else "", op_id=idx))
    shapes: dict = {}
    for ts, tid, dims in mean_ops:
        idx = _innermost(by_tid, tid, ts)
        if idx >= 0 and idx not in shapes:
            shapes[idx] = dims
    events.sort(key=lambda d: d.start)
    return Trace(window=(t_lo, t_hi), events=events, ranges=ranges,
                 shapes=shapes)


def export_and_parse(prof) -> tuple[Trace, int]:
    """(the parsed trace, its size in bytes), through a temporary file
    under ``TMPDIR`` that is removed at once."""
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            return parse(json.load(f)), size
    finally:
        os.unlink(path)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the ``sched.<op>`` range the loop thread was in (``host`` outside
    any), each as [name, seconds]."""
    by_name: dict = {}
    for e in trace.events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged((e.start, e.end) for e in trace.events)
    a0, b0 = trace.window
    edges = [a0] + [x for iv in busy for x in iv] + [b0]
    tids: dict = {}
    for r in trace.ranges:
        tids[r[3]] = tids.get(r[3], 0) + 1
    loop_tid = max(tids, key=tids.get) if tids else None
    loop = [(n, a, b, i) for i, (n, a, b, t) in enumerate(trace.ranges)
            if t == loop_tid]
    gaps: dict = {}
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        idx = _innermost({loop_tid: loop}, loop_tid, (a + b) / 2)
        name = "sched." + trace.ranges[idx][0] if idx >= 0 else "host"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
