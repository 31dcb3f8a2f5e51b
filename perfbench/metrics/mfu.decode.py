"""The decode step's share of the bf16 peak: model FLOPs of the tokens
decoded in the traced slice (perfbench/counting.py: the active weights
twice, the output head, attention over each token's context) over the
device time of the ``sched.tick`` ranges (each tick's first kernel to
its last) × 989 TFLOP/s."""

from perfbench import counting
from perfbench.kernels import op_device_s


def read(run):
    if run.trace is None or len(run.slice) != 2:
        return None
    s0, s1 = run.slice
    flops = 0.0
    for r in run.records:
        P = len(r.prompt_ids)
        n = 0
        for i, (t, d) in enumerate(r.deltas):
            for _ in d:
                if i and s0 <= t < s1:
                    flops += run.model.decode_flops(P + n)
                n += 1
    dev_s = op_device_s(run.trace, ("tick",))
    if dev_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (dev_s * counting.PEAK_BF16_FLOPS)
