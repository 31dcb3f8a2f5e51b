"""Set-up: process start to the window's opening (imports, the CUDA
context, the seeded weights and their quantization, the engine, its
warm-up and graph captures, the lead-in)."""


def read(run):
    return run.t_open - run.t_start
