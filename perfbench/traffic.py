"""The one traffic generator: a traffic file's parameters and a seed in,
requests out.

Every seed gets the same set of sizes and of gaps between arrivals, in
another order: each class's prompt and output lengths, and the open
loop's exponential gaps, are the quantiles (i + 1/2) / n of their
distributions, shuffled by the seed; the share of each class is fixed by
its weight. The seed changes the order and the text, not the work. The
Poisson schedule is the reference load generator's
(``build_schedule`` in ``loadgen``): exponential gaps at ``rate_rps``.

A traffic file (JSON)::

    {"loop": "open", "rate_rps": 4.0,      # or "closed" with "clients"
     "lead_in_s": 10, "drain_s": 60, "max_seq": 4096,
     "warm_buckets": [128, 256], "trace_s": 3,
     "classes": [{"name": ..., "weight": 4, "ttft": true,
                  "template": "...{msg}...", "head": "[{hex}] ",
                  "message_tokens" or "prompt_tokens": {"dist": "loguniform"|"uniform", "lo": .., "hi": ..},
                  "output_tokens": {...}}]}

``message_tokens`` sizes the text put in the template; ``prompt_tokens``
sizes the whole prompt with its BOS token. Under the byte tokenizer a
printable character is one token.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

_WORDS = ("the", "picnic", "plan", "meeting", "tomorrow", "we", "could",
          "bring", "salad", "bread", "and", "maybe", "a", "game", "for",
          "kids", "after", "lunch", "what", "time", "works", "best", "you",
          "thread", "quarterly", "notes", "summary", "dish", "weather",
          "park", "sounds", "good", "let", "me", "know", "soon", "thanks")

_BLOCK = 256          # requests a closed loop draws at a time


@dataclass(frozen=True)
class Request:
    index: int
    cls: str
    prompt: str
    max_tokens: int
    due_s: float          # open loop: seconds after the run's start
    ttft: bool            # counted in the TTFT percentiles


def quantile(dist: dict, u: float) -> int:
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "loguniform":
        return int(round(lo * (hi / lo) ** u))
    if dist["dist"] == "uniform":
        return int(round(lo + u * (hi - lo)))
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def strata(dist: dict, n: int, rng: random.Random) -> list:
    """n sizes at the quantiles (i + 1/2) / n, in the seed's order."""
    out = [quantile(dist, (i + 0.5) / n) for i in range(n)]
    rng.shuffle(out)
    return out


def exp_gaps(rate: float, n: int, rng: random.Random) -> list:
    out = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(out)
    return out


def text(rng: random.Random, n: int) -> str:
    """n characters of seeded words."""
    out = ""
    while len(out) < n:
        out += (" " if out else "") + rng.choice(_WORDS)
    return out[:n]


def prompt_for(cls: dict, size: int, rng: random.Random) -> str:
    """The class's template around a message with a seeded unique head:
    ``size`` characters of message, or a whole prompt of ``size`` tokens
    (BOS included) with ``prompt_tokens``."""
    head = cls.get("head", "[{hex}] ").format(hex=f"{rng.getrandbits(32):08x}")
    if "prompt_tokens" in cls:
        size = size - 1 - len(cls["template"].format(msg=""))
    return cls["template"].format(msg=head + text(rng, max(0, size - len(head))))


def class_order(classes: list, n: int, rng: random.Random) -> list:
    """n class indices, each class's share fixed by its weight."""
    total = sum(c["weight"] for c in classes)
    counts = [int(round(n * c["weight"] / total)) for c in classes]
    counts[-1] = n - sum(counts[:-1])
    order = [i for i, k in enumerate(counts) for _ in range(k)]
    rng.shuffle(order)
    return order


def block(traffic: dict, n: int, seed: int, first: int = 0,
          dues: list | None = None) -> list:
    """``n`` requests, numbered from ``first``, their sizes stratified over
    the block."""
    rng = random.Random(f"{seed}:{first}")
    classes = traffic["classes"]
    order = class_order(classes, n, rng)
    sizes = {}
    for ci, c in enumerate(classes):
        k = order.count(ci)
        key = "prompt_tokens" if "prompt_tokens" in c else "message_tokens"
        sizes[ci] = list(zip(strata(c[key], k, rng),
                             strata(c["output_tokens"], k, rng)))
    out = []
    for i, ci in enumerate(order):
        c = classes[ci]
        size, new = sizes[ci].pop()
        out.append(Request(index=first + i, cls=c["name"],
                           prompt=prompt_for(c, size, rng), max_tokens=new,
                           due_s=dues[i] if dues else 0.0,
                           ttft=bool(c.get("ttft"))))
    return out


def open_schedule(traffic: dict, seed: int, segments: list) -> list:
    """The open loop's requests, by due time, over consecutive segments of
    the given lengths in seconds (the lead-in, the window, what follows).
    Each segment holds ``round(rate_rps x length)`` arrivals, its own block
    of sizes, and its gaps scaled to fill it exactly: a Poisson schedule
    given its count, so every seed puts the same work in the window."""
    rate = float(traffic["rate_rps"])
    out: list = []
    t0 = 0.0
    for k, length in enumerate(segments):
        n = max(1, int(round(rate * length)))
        gaps = exp_gaps(rate, n + 1, random.Random(f"{seed}:gaps:{k}"))
        scale = length / sum(gaps)
        dues, t = [], t0
        for g in gaps[:n]:
            t += g * scale
            dues.append(t)
        out += block(traffic, n, seed, len(out), dues)
        t0 += length
    return out


def closed_stream(traffic: dict, seed: int):
    """The closed loop's requests, one block at a time, endlessly."""
    first = 0
    while True:
        yield from block(traffic, _BLOCK, seed, first)
        first += _BLOCK
