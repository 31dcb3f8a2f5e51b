"""Kernels A and C in admissions and chunks (``sched.admit``,
``sched.chunk``), as qmm_roofline.decode. Prefills of more than 512 rows
dequantize and run a library matmul, which is not counted here."""

from perfbench.kernels import roofline_pct


def read(run):
    if run.trace is None:
        return None
    return roofline_pct(run.trace, run.model, ("admit", "chunk"), run.slots)
