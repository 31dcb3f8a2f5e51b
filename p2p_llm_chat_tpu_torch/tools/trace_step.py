"""Device-time attribution of the decode step by kernel, the twin of the
reference's tools/trace_step.py.

The reference captures an xplane trace of N chained decode steps and
sums each HLO's self time by category. Here ``torch.profiler`` records
the device's events of N steps (kernels, copies and sets, each counted
once: a CPU op's device time would count its kernels a second time), and
:func:`attribute` groups them (:func:`kernel_group`: kernels A to E by
their ``__global__`` names, PyTorch's elementwise kernels, other) and
takes each group's time as the UNION of its events' intervals
(:func:`union_ms`): kernel B's combine, a programmatic dependent of its
split kernel, starts while the split still runs, so summed kernel times
would count the overlap twice. The sums are printed beside the unions;
the two agree wherever kernels do not overlap. The device's idle share
is taken against the step's time with CUDA events and no profiler (the
profiler slows every launch on the host).

    python -m p2p_llm_chat_tpu_torch.tools.trace_step [full|no_attn|trunk_only] [--device cuda|cpu]

runs N chained steps of ``profile_step.step_variant`` (each feeds the
last step's greedy tokens; lengths restart at ``PROF_LEN`` before each
pass) on random int8 weights of ``PROF_CONFIG`` (bench-1b) over a paged
pool of ``PROF_SLOTS`` (32) rows and a ``PROF_WINDOW`` (192) token window
(``PROF_KV_QUANT``: int8, the default, or "" for bf16), ``PROF_STEPS``
(32) steps. On the CPU the plain versions run and the events are the
CPU's operators (their union is the busy time; every one is "other").
chip_smoke.py's ``profile`` phases attribute the 32-layer steps and the
prefill through the same functions.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import torch

from .card import Rows, add_device_arg, resolve
from .mm_micro import time_ms


def kernel_group(name: str) -> str:
    """The group of a device event of a decode step, by kernel name."""
    if "qmm4_" in name:
        return "kernel C (w4a16, dense and experts)"
    if "qmm_kernel" in name or "qmm_reduce" in name:
        return "kernel A (w8a16, dense and experts)"
    if "paged_" in name and "kernel" in name:
        return "kernel B (paged attention, append, pool or verify mode)"
    if "prefill_attn_kernel" in name:
        return "kernel D (prefill attention)"
    if "w8a8" in name:
        return "kernel E (w8a8)"
    if "elementwise_kernel" in name:
        return "elementwise (norms, rope, SwiGLU, residuals, sampling)"
    return "other"


def prefill_group(name: str) -> str:
    """The group of a device event of a prefill, by kernel name."""
    if "prefill_attn_kernel" in name:
        return "kernel D (prefill attention)"
    if "qmm_kernel" in name or "qmm_reduce" in name:
        return "kernel A (w8a16, <= 512 rows)"
    low = name.lower()
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "torch matmul on the dequantized weight (> 512 rows)"
    return "other (dequantize, norms, rope, SwiGLU, copies)"


def union_ms(spans) -> float:
    """Length in ms of the union of (start, end) intervals in us."""
    total, reach = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total / 1e3


def wall_ms(fn, steps: int, dev: torch.device, warmup: int = 2) -> float:
    """Mean ms per call of ``fn(i)`` over ``steps`` calls, no profiler:
    CUDA events around the calls on the card (mm_micro.time_ms), the
    host's clock on the CPU."""
    if dev.type == "cuda":
        return time_ms(fn, steps, warmup)
    for i in range(warmup):
        fn(i)
    t0 = time.perf_counter()
    for i in range(steps):
        fn(i)
    return (time.perf_counter() - t0) * 1e3 / steps


def profiled(fn, steps: int, dev: Optional[torch.device] = None):
    """(wall ms per call with no profiler; the events of ``steps`` calls
    under torch.profiler as (name, start us, end us)): the device's on
    the card, the CPU operators' on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = dev or torch.device("cuda")
    cuda = dev.type == "cuda"
    wall = wall_ms(fn, steps, dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for i in range(steps):
            fn(i)
        if cuda:
            torch.cuda.synchronize()
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    return wall, [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == want]


def group_times(events, n: int) -> dict:
    """{group: [union ms per step, launches, summed ms per step]} of
    ``events`` over ``n`` steps, with ``"busy"`` (the union of every
    event, ms per step) and ``"other_names"`` ({name: [union ms per step,
    launches]} of the events in "other")."""
    spans: dict[str, list] = {}
    other: dict[str, list] = {}
    for name, a, b in events:
        g = kernel_group(name)
        spans.setdefault(g, []).append((a, b))
        if g == "other":
            other.setdefault(name, []).append((a, b))
    out = {g: [union_ms(v) / n, len(v), sum(b - a for a, b in v) / 1e3 / n]
           for g, v in spans.items()}
    out["busy"] = union_ms([x for v in spans.values() for x in v]) / n
    out["other_names"] = {k: [union_ms(v) / n, len(v)]
                          for k, v in other.items()}
    return out


def attribute(label: str, fn, steps: int, K: int = 1,
              dev: Optional[torch.device] = None, show=print) -> dict:
    """Time ``fn`` (``K`` steps a call) and attribute its device time by
    group, printing one line for the whole and one per group (and the six
    largest "other" events). Returns ``{"wall_ms", "busy_ms",
    "idle_share", "groups"}`` per step."""
    dev = dev or torch.device("cuda")
    wall, events = profiled(fn, steps, dev)
    wall /= K
    n = steps * K
    g = group_times(events, n)
    busy = g.pop("busy")
    other = g.pop("other_names")
    out = {"wall_ms": wall, "busy_ms": busy, "groups": g,
           "idle_share": max(0.0, 1 - busy / wall) if wall else None}
    if busy == 0:
        show(f"  {label}: {wall:.3f} ms per step (no profiler); the "
             "profiler saw no event inside the calls")
        return out
    show(f"  {label}: {wall:.3f} ms per step ({steps} calls of {K} "
         f"step{'s' * (K > 1)}, no profiler); busy {busy:.3f} ms "
         f"per step (sum of event times "
         f"{sum(v[2] for v in g.values()):.3f}) -> idle share "
         f"{out['idle_share']:.1%}; {len(events) // n} events per step")
    for name, (ms, cnt, ms_sum) in sorted(g.items(), key=lambda kv: -kv[1][0]):
        show(f"    {name}: {ms:.3f} ms per step (sum {ms_sum:.3f}) over "
             f"{cnt // n} launches ({ms / busy:.1%} of busy time)")
    for name, (ms, cnt) in sorted(other.items(),
                                  key=lambda kv: -kv[1][0])[:6]:
        show(f"      other: {ms:.3f} ms per step, {cnt // n} launches: "
             f"{name[:90]}")
    return out


def main(argv: Optional[list[str]] = None) -> dict:
    from ..models import family_for
    from ..models.configs import get_config
    from . import profile_step
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variant", nargs="?", default="full",
                    choices=("full", "no_attn", "trunk_only"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    env = profile_step.prof_env()
    cfg = get_config(env["config"])
    B, window, L0, steps = (env["slots"], env["window"], env["length"],
                            env["steps"])
    if L0 + 2 + steps > window:
        raise SystemExit(f"PROF_LEN {L0} + {steps} steps overflow the "
                         f"{window}-token window")
    params = family_for(cfg).init_params_quantized(cfg, seed=0, quant="int8",
                                                   device=dev)
    cache, pages = profile_step.make_cache(cfg, B, window, L0,
                                           env["kv_quant"], dev,
                                           params["embed"].dtype)
    toks = torch.ones((B, 1), dtype=torch.long, device=dev)

    def call(i: int) -> None:
        if i == 0:
            cache.lengths.fill_(L0)
        out, _ = profile_step.step_variant(params, cfg, toks, cache,
                                           pages=pages, variant=args.variant)
        if args.variant != "trunk_only":       # trunk_only has no logits
            toks.copy_(out[:, -1].argmax(-1, keepdim=True))

    show = Rows(dev)
    show(f"trace_step: {cfg.name}, int8 weights, "
         f"{'int8' if env['kv_quant'] else 'bf16'} pool, B={B}, window "
         f"{window}, {L0} tokens a row at the start, {steps} chained steps, "
         f"variant {args.variant}, on {dev}")
    return attribute(args.variant, call, steps, dev=dev, show=show)


if __name__ == "__main__":
    main()
