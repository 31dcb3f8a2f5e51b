"""The quantized matmuls of a traced slice, each launch with its least time.

Kernel A (``csrc/quant_mm.cu``, int8 weights) and kernel C
(``csrc/quant_mm4.cu``, int4) are found by their ``__global__`` names; a
split-K launch's reduce kernel counts with the launch before it. A
launch's weight is told by its grid's first axis (output tiles of 128
columns) among the configuration's output widths, and ``wo`` from
``w_down`` (both ``hidden`` wide) by whether the launch before it in the
same range was ``wgu``. Its rows: a decode tick's graph runs every slot;
an admission or a chunk runs ``R × S`` rows (the ``[R, S, hidden]`` of
the range's first ``aten::mean``, the first RMSNorm), its output head
``R``. An expert launch is counted under :func:`counting.expert_rows_read`.
"""

from __future__ import annotations

from . import counting
from .reference.quant import int4_group

_TILE = 128


def _is_main(name: str) -> bool:
    return ("qmm_kernel" in name or "qmm4_" in name) and "reduce" not in name


def _is_reduce(name: str) -> bool:
    return "qmm_reduce" in name or "qmm4_reduce" in name


def _weights(m: counting.Model) -> dict:
    """Output tiles -> (leaf, K, O); ``hidden`` is ``wo`` here, and
    ``w_down`` after ``wgu``."""
    H = m.hidden
    out = {}
    for leaf, K, O in (("wqkv", H, m.q_dim + 2 * m.kv_dim), ("wo", m.q_dim, H),
                       ("wgu", H, 2 * m.intermediate), ("lm_head", H, m.vocab)):
        out[-(-O // _TILE)] = (leaf, K, O)
    return out


def launches(trace, m: counting.Model, ops: tuple, slots: int) -> list:
    """[(leaf, least seconds, device seconds)] of the A and C launches
    attributed to ``ops`` that can be counted; launches whose rows are
    unknown, or whose expert count is left out, are not listed."""
    table = _weights(m)
    out: list = []
    prev: dict = {}
    cur = None
    for e in trace.events:
        if e.op not in ops:
            continue
        if _is_reduce(e.name):
            if cur is not None and cur[3] == e.op_id:
                cur[2] += (e.end - e.start) / 1e6
            continue
        if not _is_main(e.name) or not e.grid:
            continue
        hit = table.get(e.grid[0])
        last = prev.get(e.op_id)
        prev[e.op_id] = hit[0] if hit else None
        cur = None
        if hit is None:
            continue
        leaf, K, O = hit
        if leaf == "wo" and last == "wgu":
            leaf, K = "w_down", m.intermediate
        if e.op == "tick":
            R, rows = slots, slots
        else:
            dims = trace.shapes.get(e.op_id)
            if dims is None:
                continue
            R, rows = dims[0], dims[0] * dims[1]
        if leaf == "lm_head":
            rows = R
        expert = bool(m.experts) and leaf in ("wgu", "w_down")
        mode = "int4" if "qmm4_" in e.name else "int8"
        group = int4_group(K, expert) if mode == "int4" else None
        wb = counting.weight_bytes(K, O, mode, group)
        if expert:
            n = counting.expert_rows_read(rows, m.experts, m.top_k)
            if n is None:
                continue
            flops, nbytes = counting.matmul(rows * m.top_k, K, O, n * wb)
        else:
            flops, nbytes = counting.matmul(rows, K, O, wb)
        cur = [leaf, counting.bound_s(flops, nbytes),
               (e.end - e.start) / 1e6, e.op_id]
        out.append(cur)
    return [(leaf, b, t) for leaf, b, t, _ in out]


def coverage(trace, m: counting.Model, ops: tuple, slots: int) -> tuple:
    """(device seconds of the launches :func:`launches` counts, device
    seconds of every A and C launch and reduce in ``ops``)."""
    counted = sum(x[2] for x in launches(trace, m, ops, slots))
    total = sum((e.end - e.start) / 1e6 for e in trace.events
                if e.op in ops and (_is_main(e.name) or _is_reduce(e.name)))
    return counted, total


def roofline_pct(trace, m: counting.Model, ops: tuple, slots: int):
    ls = launches(trace, m, ops, slots)
    t = sum(x[2] for x in ls)
    return None if not ls or t <= 0 else 100.0 * sum(x[1] for x in ls) / t


def op_device_s(trace, ops: tuple) -> float:
    """Summed device span (first event's start to last event's end) of
    each range of ``ops``: the device's time on those ranges' work."""
    spans: dict = {}
    for e in trace.events:
        if e.op in ops:
            a, b = spans.get(e.op_id, (e.start, e.end))
            spans[e.op_id] = (min(a, e.start), max(b, e.end))
    return sum(b - a for a, b in spans.values()) / 1e6
