"""The share (%) of the suggestions counted in the window whose first
token came within 4 s of due: the reference's ``short_chat`` TTFT target
at the median (``loadgen/scenarios.py``), held per request. A suggestion
that failed, was shed or had no first token by the drain limit is
outside."""


def read(run):
    return run.within_ms(4000.0)
