"""Twins of the reference's tools/ scripts that reach a kernel:
:mod:`.mm_micro` (the decode-shaped matmul microbenchmark with the w8a8
prototype, kernel E)."""
