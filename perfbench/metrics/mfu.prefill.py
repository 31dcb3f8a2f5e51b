"""Prefill's share of the bf16 peak: model FLOPs of the prompt tokens
computed (the cached prefix is not) by requests whose ``sched.prefill``
span meets the traced slice, each pro-rated by the share of its span
inside the slice, over the device time of the ``sched.admit`` and
``sched.chunk`` ranges × 989 TFLOP/s."""

from perfbench import counting
from perfbench.kernels import op_device_s


def read(run):
    if run.trace is None or len(run.slice) != 2:
        return None
    s0, s1 = run.slice
    flops = 0.0
    for r in run.records:
        for s in run.spans.get(r.trace_id, ()):
            if s["name"] != "sched.prefill" or s["dur_ms"] <= 0:
                continue
            a = s["t0_ms"] / 1e3 - run.anchor
            b = a + s["dur_ms"] / 1e3
            share = max(0.0, min(b, s1) - max(a, s0)) / (b - a)
            cached = run.cached_tokens(r)
            flops += share * run.model.prefill_flops(
                len(r.prompt_ids) - cached, cached)
    dev_s = op_device_s(run.trace, ("admit", "chunk"))
    if dev_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (dev_s * counting.PEAK_BF16_FLOPS)
