"""What the tool twins share: the device rule, the card's name and power
limit on every row they print, the device timing and the bound.

- :func:`resolve`: ``--device`` defaults to ``cuda``; without a card that
  raises unless ``--device cpu`` asks for the CPU (utils/device.py), and
  nothing falls back.
- :func:`card_line`: ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` on the card (a card below its 700 W maximum
  runs slower under load), ``cpu`` on the CPU.
- :func:`step_ms`: ms per call of ``fn(i)``. On the card it is the least
  of :data:`SOLVES` of mm_micro's ``device_ms`` (``n1`` and ``n2`` calls
  captured into two CUDA graphs, each replay timed with events, and
  ``two_length_ms`` of the two: neither the host's dispatch nor a graph's
  launch is counted). On an H100, graphs of a llama3.1-8b decode step run
  at one of two levels about 6% apart at unchanged SM and memory clocks,
  and one capture after another of the same function tends to land on
  the same level, so readings of one function taken in different phases
  have differed by 6-8%; the least of nine takes the faster level when a
  capture reaches it. Two functions that must agree closely are compared
  by their device busy time instead (tools/trace_step.attribute). On the
  CPU, wall time of ``n1`` and ``n2`` calls and the same difference.
- :func:`bound_ms`: the least time of some work on an H100 SXM, the larger
  of its bytes over the memory rate and its operations over the bf16 rate
  (data-sheet peaks, dense).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..utils.device import resolve_device
from .mm_micro import PEAK_BYTES_PER_S, device_ms, two_length_ms

PEAK_BF16_FLOPS = 989e12
SOLVES = 9


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(the plain versions, at the sizes given)")


def resolve(device: str) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def card_line(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines = out.stdout.strip().splitlines()
        return (lines[0] if lines
                else f"unknown (nvidia-smi exit {out.returncode})")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"


class Rows:
    """Prints each row with the card it was measured on."""

    def __init__(self, dev: torch.device) -> None:
        self.card = card_line(dev)

    def __call__(self, text: str) -> None:
        print(f"{text} [card: {self.card}]", flush=True)


def _wall_ms(fn, n: int) -> float:
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) * 1e3


def step_ms(fn, dev: torch.device, n1: int, n2: int) -> float:
    """ms per call of ``fn(i)`` (see the module's docstring)."""
    if dev.type == "cuda":
        return min(device_ms(fn, n1, n2, reps=3) for _ in range(SOLVES))
    fn(0)
    return two_length_ms(_wall_ms(fn, n1), _wall_ms(fn, n2), n1, n2)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the two times."""
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")
