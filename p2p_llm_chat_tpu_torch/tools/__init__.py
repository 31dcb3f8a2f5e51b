"""Twins of the reference's tools/ scripts that reach a kernel or a step:
:mod:`.mm_micro` (the decode-shaped matmul microbenchmark with the w8a8
prototype, kernel E), :mod:`.profile_step` (the decode step's ablation
variants), :mod:`.trace_step` (device time by kernel group),
:mod:`.check_quant_kernel` (kernels A and C against their plain versions
and the library), :mod:`.check_append_kernel` and
:mod:`.time_append_kernel` (kernel B's append mode), sharing
:mod:`.card` (the device rule, the card line, device timing, the
bound)."""
