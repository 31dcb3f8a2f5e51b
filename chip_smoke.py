#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (p2p_llm_chat_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. build  — nvcc builds both CUDA kernels from csrc/ (in parallel);
2. kernel — each kernel against its plain PyTorch version on the card at
   the llama3.1-8b shapes, with CUDA-event timings beside the bound;
3. step   — one full-width llama3.1-8b decode step (depth cut to 2
   layers) through the kernels on the card, against the same step
   through the plain path on the CPU (same weights, same pool);
4. server — the port's engine (llama3.1-8b, 32 layers, int8 weights, int8
   paged KV) behind its Ollama front on localhost answers 6 concurrent
   requests; the kernels' launch counters are zeroed just before and
   read just after, and both must have grown.

Optional (``--only build,profile``): ``profile`` — one 32-layer
llama3.1-8b decode step at B=8, W=1024, timed with CUDA events and broken
down by kernel with torch.profiler, with the device's idle share.

Prints the card's name and power limit early, a ``{"kernels": [...]}``
JSON line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--only build,kernel`` runs a subset (for iterating on a kernel).
Exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger
# of its bytes over the memory rate and its operations over the bf16 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
L2_BYTES = 50 * 2 ** 20

A_TOL = 1e-2        # of max|plain|: one bf16 rounding of the output (2^-8)
#                     either side + f32 summation order
B_TOL = 1e-2        # of max|plain|: the plain version rounds the p.v
#                     operands to bf16 (2^-8 relative each), the kernel
#                     keeps f32; plus one bf16 rounding of the output
STEP_TOL = 5e-2     # of max|logits|: bf16 activations through 2 layers,
#                     rounded at different places on the two paths


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn(i)`` over ``n`` calls, CUDA events."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"unknown (nvidia-smi exit {out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"


# -- phase 1: build -----------------------------------------------------------

def phase_build() -> None:
    from p2p_llm_chat_tpu_torch.ops import _build
    t0 = time.monotonic()
    errs: dict[str, BaseException] = {}

    def one(name: str) -> None:
        try:
            _build.build(name)
        except BaseException as e:   # noqa: BLE001 — reported below
            errs[name] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in _build.KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, e in errs.items():
        print(f"build {name}: FAILED\n{e}", flush=True)
    check(not errs, f"kernel build failed: {sorted(errs)}")
    print(f"build: {len(_build.KERNELS)} kernels in "
          f"{time.monotonic() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


# -- phase 2: kernels ---------------------------------------------------------

A_SHAPES = {          # llama3.1-8b projections: (H, O, launches per step)
    "wqkv": (4096, 6144, 32),
    "wo": (4096, 4096, 32),
    "wgu": (4096, 28672, 32),
    "w_down": (14336, 4096, 32),
    "lm_head": (4096, 128256, 1),
}


def phase_kernel_a(results: dict) -> None:
    import torch
    from p2p_llm_chat_tpu_torch.models.quant import dequantize, quantize
    from p2p_llm_chat_tpu_torch.ops.quant_mm import (quant_matmul,
                                                     quant_matmul_reference)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    worst_abs = 0.0
    worst_rel = 0.0

    def check_case(label, x, q, s, layer):
        nonlocal worst_abs, worst_rel
        out = quant_matmul(x, q, s, layer)
        ref = quant_matmul_reference(x, q, s, layer)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"kernel A {label}: non-finite")
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rel = err / max(scale, 1e-30)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        print(f"  kernel A {label}: max_abs_err {err:.3e} max_rel_err "
              f"{rel:.3e} (tol {A_TOL:.0e} of max|plain| {scale:.3e})")
        check(rel <= A_TOL, f"kernel A {label}: rel err {rel:.3e} > {A_TOL}")

    def rand_q(H, O, L=None):
        shape = (H, O) if L is None else (L, H, O)
        w = torch.randn(shape, generator=gen, device=dev) * H ** -0.5
        return quantize(w.to(torch.bfloat16))

    # Ragged tiny shapes: O not a multiple of 16 (the byte-load path), H
    # not a multiple of the 64-wide K step, stacked at a layer offset.
    for (M, H, O) in ((5, 100, 200), (3, 128, 256)):
        qt = rand_q(H, O, L=2)
        x = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        check_case(f"ragged M={M} H={H} O={O} layer=1", x, qt.q, qt.s, 1)

    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    prefill_ms = 0.0
    bound_kind = {"bytes": 0, "operations": 0}
    for name, (H, O, per_step) in A_SHAPES.items():
        # A layer stack big enough that rotating through it keeps the
        # timed weight reads cold in the 50 MB L2, as in a real step.
        nl = 1 if name == "lm_head" else max(2, min(8, math.ceil(
            3 * L2_BYTES / (H * O))))
        qt = rand_q(H, O, L=None if name == "lm_head" else nl)
        layer_of = (lambda i: None) if name == "lm_head" else \
            (lambda i, nl=nl: i % nl)
        for M in (1, 8, 32, 512):
            x = torch.randn((M, H), generator=gen, device=dev).to(
                torch.bfloat16)
            check_case(f"{name} M={M} H={H} O={O}", x, qt.q, qt.s,
                       layer_of(1))
        # Prefill-shaped calls (up to 512 rows) run kernel A too.
        x = torch.randn((512, H), generator=gen, device=dev).to(
            torch.bfloat16)
        ms = time_ms(lambda i: quant_matmul(x, qt.q, qt.s, layer_of(i)), 10)
        b_ms, kind = bound_ms(H * O + 4 * O + 2 * 512 * (H + O),
                              2.0 * 512 * H * O)
        print(f"  kernel A {name} M=512: {ms * 1e3:.1f} us (bound "
              f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of bound; "
              f"{2.0 * 512 * H * O / ms / 1e9:.1f} TFLOP/s)")
        if name != "lm_head":      # prefill's lm_head sees 1 row/prompt
            prefill_ms += per_step * ms
        M = 8                      # the decode tick at SERVE_SLOTS=8
        x = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        ms = time_ms(lambda i: quant_matmul(x, qt.q, qt.s, layer_of(i)), 50)
        plain = time_ms(lambda i: quant_matmul_reference(
            x, qt.q, qt.s, layer_of(i)), 5, warmup=1)
        if name == "lm_head":
            wl = [dequantize(qt, torch.bfloat16)]
        else:
            wl = [dequantize(type(qt)(qt.q[i], qt.s[i]), torch.bfloat16)
                  for i in range(nl)]
        lib = time_ms(lambda i: torch.matmul(x, wl[i % len(wl)]), 50)
        del wl
        b_ms, kind = bound_ms(H * O + 4 * O + 2 * M * H + 2 * M * O,
                              2.0 * M * H * O)
        bound_kind[kind] += per_step
        print(f"  kernel A {name} M=8: {ms * 1e3:.1f} us (bound "
              f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of bound); "
              f"plain {plain * 1e3:.1f} us; torch.matmul on a "
              f"pre-dequantized bf16 weight {lib * 1e3:.1f} us")
        step["ms"] += per_step * ms
        step["plain_ms"] += per_step * plain
        step["bound_ms"] += per_step * b_ms
        step["library_ms"] += per_step * lib
        del qt
        torch.cuda.empty_cache()
    print(f"  kernel A per decode step (129 launches, B=8): "
          f"{step['ms']:.3f} ms vs bound {step['bound_ms']:.3f} ms; the 128 "
          f"layer launches of a 512-row prefill: {prefill_ms:.3f} ms")
    results["quant_matmul"] = dict(
        name="quant_matmul", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/quant_mm.cu",
        replaces="p2p_llm_chat_tpu/ops/quant_mm.py:241",
        also_replaces="p2p_llm_chat_tpu/ops/quant_mm.py:383",
        max_abs_err=worst_abs, max_rel_err=worst_rel,
        bound_by=max(bound_kind, key=bound_kind.get),
        scope="one llama3.1-8b decode step at B=8: 32 x (wqkv, wo, wgu, "
              "w_down) + lm_head = 129 launches; library_ms is torch.matmul "
              "on pre-dequantized bf16 weights",
        **{k: round(v, 4) for k, v in step.items()})


def _paged_case(quantized, Hq, Hkv, D, W, lengths, L=2, ps=64, seed=0,
                nan_page0=True):
    """A pool whose rows own disjoint pages (positions past each row's
    allocation map to page 0, filled with NaN/Inf garbage), plus bf16
    q / k_cur / v_cur."""
    import torch
    from p2p_llm_chat_tpu_torch.ops.paged_kv import PagedKVCache
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    pages = -(-W // ps)
    alloc = [max(1, -(-n // ps)) for n in lengths]
    N = 1 + sum(alloc)
    kd = torch.int8 if quantized else torch.bfloat16
    shape = (L, N, ps, Hkv, D)
    if quantized:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ps_pad = -(-ps // 128) * 128
        ks = torch.rand((L, N, Hkv, ps_pad), generator=gen, device=dev) / 64
        vs = torch.rand((L, N, Hkv, ps_pad), generator=gen, device=dev) / 64
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(kd)
        v = torch.randn(shape, generator=gen, device=dev).to(kd)
        ks = vs = None
    if nan_page0:
        if quantized:
            ks[:, 0] = float("nan")
            vs[:, 0] = float("inf")
        else:
            k[:, 0] = float("nan")
            v[:, 0] = float("nan")
    pt = torch.zeros((B, pages), dtype=torch.int32)
    nxt = 1
    for b, a in enumerate(alloc):
        n = min(a, pages)
        pt[b, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += a
    cache = PagedKVCache(k=k, v=v, page_table=pt.to(dev),
                         lengths=torch.tensor(lengths, dtype=torch.int32,
                                              device=dev),
                         k_scale=ks, v_scale=vs)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    kc = torch.randn((B, Hkv, D), generator=gen, device=dev).to(
        torch.bfloat16)
    vc = torch.randn((B, Hkv, D), generator=gen, device=dev).to(
        torch.bfloat16)
    return cache, q, kc, vc, pages


def phase_kernel_b(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from p2p_llm_chat_tpu_torch.ops.paged_attention import (
        paged_attention_append, paged_attention_append_reference)
    worst = 0.0
    for quantized in (True, False):
        for (Hq, Hkv, D) in ((4, 2, 32), (32, 8, 128)):
            for W in (64, 1000, 4096):
                # Ragged: a full window, a partial last page, one short
                # row, a single token; windows past the allocation read
                # the NaN-filled garbage page 0.
                lengths = [W, max(1, W - 37), max(1, W // 3 + 5), 1]
                cache, q, kc, vc, pages = _paged_case(quantized, Hq, Hkv, D,
                                                      W, lengths, seed=W)
                out = paged_attention_append(q, kc, vc, cache, cache.lengths,
                                             1, pages=pages)
                ref = paged_attention_append_reference(
                    q, kc, vc, cache, cache.lengths, 1, pages=pages)
                torch.cuda.synchronize()
                label = (f"{'int8' if quantized else 'bf16'} Hq={Hq} "
                         f"Hkv={Hkv} D={D} W={W} lengths={lengths}")
                check(bool(torch.isfinite(out).all()),
                      f"kernel B {label}: non-finite output")
                check(bool(torch.isfinite(ref).all()),
                      f"kernel B {label}: non-finite plain output")
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                rel = err / max(scale, 1e-30)
                worst = max(worst, err)
                print(f"  kernel B {label}: max_abs_err {err:.3e} "
                      f"max_rel_err {rel:.3e} (tol {B_TOL:.0e} of "
                      f"max|plain| {scale:.3f})")
                check(rel <= B_TOL, f"kernel B {label}: rel err {rel:.3e} "
                      f"> {B_TOL}")
                del cache
    # Timing at the serving shape: llama3.1-8b geometry, B=8, W=1024, int8,
    # a pool of 8 layers so rotating layers keeps the reads cold in L2.
    B, W, Hq, Hkv, D, L = 8, 1024, 32, 8, 128, 8
    cache, q, kc, vc, pages = _paged_case(True, Hq, Hkv, D, W, [W] * B, L=L,
                                          seed=99, nan_page0=False)
    ms = time_ms(lambda i: paged_attention_append(
        q, kc, vc, cache, cache.lengths, i % L, pages=pages), 100)
    plain = time_ms(lambda i: paged_attention_append_reference(
        q, kc, vc, cache, cache.lengths, i % L, pages=pages), 10, warmup=1)
    # Yardstick: SDPA over an already-gathered, dequantized window with
    # the current token appended (the gather is NOT timed).
    ps = cache.page_size
    kw, vw = [], []
    for layer in range(L):
        idx = cache.page_table[:, :pages].long()
        kl = cache.k[layer][idx].reshape(B, W, Hkv, D).float()
        vl = cache.v[layer][idx].reshape(B, W, Hkv, D).float()
        sk = cache.k_scale[layer][idx][..., :ps].transpose(1, 2).reshape(
            B, Hkv, W)
        sv = cache.v_scale[layer][idx][..., :ps].transpose(1, 2).reshape(
            B, Hkv, W)
        kl = kl * sk.transpose(1, 2)[..., None]
        vl = vl * sv.transpose(1, 2)[..., None]
        kl = torch.cat([kl, kc.float()[:, None]], 1).to(torch.bfloat16)
        vl = torch.cat([vl, vc.float()[:, None]], 1).to(torch.bfloat16)
        kw.append(kl.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1))
        vw.append(vl.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1))
    q4 = q[:, :, None, :]
    lib = time_ms(lambda i: F.scaled_dot_product_attention(
        q4, kw[i % L], vw[i % L]), 100)
    del kw, vw
    tokens = B * W
    nbytes = (tokens * Hkv * D * 2 + tokens * Hkv * 2 * 4
              + (q.numel() + kc.numel() + vc.numel() + q.numel()) * 2)
    b_ms, kind = bound_ms(nbytes, 4.0 * tokens * Hq * D)
    print(f"  kernel B int8 B={B} W={W} (8B geometry): {ms * 1e3:.1f} us "
          f"per layer (bound {b_ms * 1e3:.1f} us, {kind}; "
          f"{b_ms / ms:.0%} of bound); plain {plain * 1e3:.1f} us; SDPA on "
          f"a pre-gathered bf16 window (gather excluded) {lib * 1e3:.1f} us")
    results["paged_attention_append"] = dict(
        name="paged_attention_append", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/paged_attention.cu",
        replaces="p2p_llm_chat_tpu/ops/paged_attention.py:993",
        max_abs_err=worst, bound_by=kind,
        scope="one llama3.1-8b decode step at B=8, W=1024, int8 pool: 32 "
              "launches (one per layer); library_ms is SDPA over an "
              "already-gathered dequantized window, excluding the gather",
        ms=round(32 * ms, 4), plain_ms=round(32 * plain, 4),
        bound_ms=round(32 * b_ms, 4), library_ms=round(32 * lib, 4))


# -- phase 3: one full-width decode step, card vs CPU -------------------------

def phase_step() -> None:
    import torch
    from p2p_llm_chat_tpu_torch.models import llama
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.quant import QTensor
    from p2p_llm_chat_tpu_torch.ops.paged_kv import (PagedKVCache,
                                                     write_prefill_batch)
    cfg = get_config("llama3.1-8b").with_(num_layers=2)
    dev = torch.device("cuda")
    params = llama.init_params_quantized(cfg, seed=7, device=dev)

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, QTensor):
            return QTensor(t.q.cpu(), t.s.cpu())
        return t.cpu()

    gen = torch.Generator().manual_seed(3)
    n = 100
    S = 128
    toks = torch.zeros((1, S), dtype=torch.long)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
    lens = torch.tensor([n])
    ps, B, mppr = 64, 2, 4
    cache = PagedKVCache.create(cfg, B, 1 + B * mppr, ps,
                                max_pages_per_row=mppr, quantized=True,
                                device=dev)
    logits, k_all, v_all = llama.prefill(params, cfg, toks.to(dev),
                                         lens.to(dev), last_only=True)
    tables = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    write_prefill_batch(cache, k_all, v_all, torch.tensor([0]), lens, tables)
    cpu_cache = PagedKVCache(*(None if t is None else t.cpu() for t in (
        cache.k, cache.v, cache.page_table, cache.lengths, cache.k_scale,
        cache.v_scale)))
    tok = logits[:, 0].argmax(-1).reshape(1, 1)
    tokens = torch.cat([tok, torch.zeros_like(tok)])     # row 1 parked
    active = torch.tensor([True, False])
    pages = -(-n // ps)
    out_gpu, _ = llama.decode_step_paged(params, cfg, tokens, cache,
                                         active.to(dev), pages=pages)
    torch.cuda.synchronize()
    params_cpu = to_cpu(params)
    del params
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out_cpu, _ = llama.decode_step_paged(params_cpu, cfg, tokens.cpu(),
                                         cpu_cache, active, pages=pages)
    cpu_s = time.monotonic() - t0
    g, c = out_gpu[0, 0].float().cpu(), out_cpu[0, 0].float()
    check(bool(torch.isfinite(g).all()), "step: non-finite card logits")
    err = (g - c).abs().max().item()
    scale = c.abs().max().item()
    same = int(g.argmax()) == int(c.argmax())
    print(f"step: llama3.1-8b dims, 2 layers, int8 weights + int8 pool, "
          f"prompt {n}: card vs CPU plain logits max_abs_err {err:.4f}, "
          f"max|logits| {scale:.3f} (tol {STEP_TOL:.0e} of max), argmax "
          f"{'equal' if same else 'differs'}; CPU step {cpu_s:.1f} s")
    check(err <= STEP_TOL * scale, f"step: logits err {err:.4f} > "
          f"{STEP_TOL} x {scale:.3f}")
    check(torch.equal(cache.lengths.cpu(), cpu_cache.lengths),
          "step: lengths differ")


# -- optional phase: where one full-depth decode step spends its time ---------

def _kernel_group(name: str) -> str:
    if "qmm_kernel" in name or "qmm_reduce" in name:
        return "kernel A (quant_matmul)"
    if "append_split_kernel" in name or "append_combine_kernel" in name:
        return "kernel B (paged_attention_append)"
    return "other"


def phase_profile(B: int = 8, W: int = 1024, steps: int = 10) -> None:
    """One llama3.1-8b decode step (32 layers, int8 weights, int8 pool) at
    ``B`` rows of ``W`` pool tokens: wall time with CUDA events over
    ``steps`` steps, then a torch.profiler pass summing device time by
    kernel (each kernel once, as its own event) and the device's idle
    share of the profiled wall time. Not part of the default run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from p2p_llm_chat_tpu_torch.models import llama
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.ops.paged_kv import PagedKVCache
    cfg = get_config("llama3.1-8b")
    dev = torch.device("cuda")
    params = llama.init_params_quantized(cfg, seed=5, device=dev)
    ps = 64
    per_row = W // ps + 1                       # + the page the step writes
    cache = PagedKVCache.create(cfg, B, 1 + B * per_row, ps,
                                max_pages_per_row=per_row, quantized=True,
                                device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    cache.k.random_(-127, 128, generator=gen)
    cache.v.random_(-127, 128, generator=gen)
    cache.k_scale.uniform_(0.0, 1.0 / 64, generator=gen)
    cache.v_scale.uniform_(0.0, 1.0 / 64, generator=gen)
    cache.page_table.copy_(1 + torch.arange(B * per_row, device=dev,
                                            dtype=torch.int32).reshape(
                                                B, per_row))
    tokens = torch.randint(0, 256, (B, 1), generator=gen, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    pages = -(-(W + 1) // ps)

    def step(_i: int = 0) -> None:
        cache.lengths.fill_(W)
        llama.decode_step_paged(params, cfg, tokens, cache, active,
                                pages=pages)

    wall = time_ms(step, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / steps
    # Device-side events only (kernels, copies, sets), each counted once;
    # a CPU op's device time would count its kernels a second time.
    groups: dict[str, list] = {}
    other: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / steps
        g = _kernel_group(e.name)
        keys = [(groups, g)] + ([(other, e.name)] if g == "other" else [])
        for d, key in keys:
            acc = d.setdefault(key, [0.0, 0])
            acc[0] += ms
            acc[1] += 1
    busy = sum(v[0] for v in groups.values())
    check(busy > 0, "profile: the profiler saw no device time")
    # The profiler slows every launch on the host, so the idle share is
    # taken against the unprofiled step time (device kernel times are
    # not inflated by it).
    print(f"profile: llama3.1-8b decode step, 32 layers, int8 weights + "
          f"int8 pool, B={B} W={W}: {wall:.3f} ms per step (CUDA events, "
          f"{steps} steps, no profiler); device busy {busy:.3f} ms per "
          f"step -> idle share {max(0.0, 1 - busy / wall):.1%}; under the "
          f"profiler {prof_wall:.3f} ms wall per step")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g}: {ms:.3f} ms per step over {n // steps} launches "
              f"({ms / busy:.1%} of device time)")
    for key, (ms, n) in sorted(other.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    other: {ms:.3f} ms per step, {n // steps} launches: "
              f"{key[:90]}")


# -- phase 4: the server ------------------------------------------------------

def _post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def phase_server(results: dict) -> None:
    import torch
    from p2p_llm_chat_tpu_torch.ops.paged_attention import \
        paged_attention_append
    from p2p_llm_chat_tpu_torch.ops.quant_mm import quant_matmul
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env

    os.environ.update(SERVE_BACKEND="torch", MODEL_CONFIG="llama3.1-8b",
                      SERVE_KV="paged", SERVE_QUANT="int8",
                      SERVE_KV_QUANT="int8", SERVE_SLOTS="8",
                      SERVE_MAX_SEQ="4096", SERVE_DEVICE="cuda")
    t0 = time.monotonic()
    engine = build_engine_from_env()
    server = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        deadline = time.monotonic() + 600
        while not engine.ready():
            err = engine.warmup_error
            check(err is None, f"server: warmup failed: {err!r}")
            check(time.monotonic() < deadline, "server: never became ready")
            time.sleep(0.1)
        print(f"server: llama3.1-8b (32 layers, int8 weights, int8 paged "
              f"KV, 8 slots, max_seq 4096) ready in "
              f"{time.monotonic() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        url = server.url
        long_prompt = ("The co-pilot reads the whole conversation before it "
                       "drafts a reply. " * 40)[:1500]
        reqs = [
            ("/api/generate", {"prompt": "Draft a reply to: see you at "
                               "noon?", "stream": False,
                               "options": {"num_predict": 24}}),
            ("/api/generate", {"prompt": "hello there", "stream": True,
                               "options": {"num_predict": 24,
                                           "temperature": 0.8, "seed": 11,
                                           "top_k": 40, "top_p": 0.9}}),
            ("/api/chat", {"messages": [{"role": "user",
                                         "content": "how are you?"}],
                           "stream": False, "options": {"num_predict": 16}}),
            ("/api/generate", {"prompt": long_prompt, "stream": False,
                               "options": {"num_predict": 16}}),
            ("/api/generate", {"prompt": "stream me", "stream": True,
                               "options": {"num_predict": 32}}),
            ("/api/generate", {"prompt": "penalised", "stream": False,
                               "options": {"num_predict": 20,
                                           "repeat_penalty": 1.1}}),
        ]
        quant_matmul.launches = 0
        paged_attention_append.launches = 0
        answers: list = [None] * len(reqs)

        def run(i: int) -> None:
            try:
                answers[i] = _post(url + reqs[i][0], reqs[i][1])
            except Exception as e:   # noqa: BLE001 — checked below
                answers[i] = e

        t_burst = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.monotonic() - t_burst
        finals = []
        for (path, body), ans in zip(reqs, answers):
            check(not isinstance(ans, Exception), f"server {path}: {ans!r}")
            status, text = ans
            check(status == 200, f"server {path}: status {status}")
            lines = [json.loads(x) for x in text.splitlines() if x.strip()]
            check(len(lines) >= 1, f"server {path}: empty body")
            rec = lines[-1]
            check(rec.get("done") is True and "error" not in rec,
                  f"server {path}: bad final record {rec}")
            if body.get("stream"):
                check(all(x.get("done") is False for x in lines[:-1]),
                      f"server {path}: malformed stream")
            n_pred = body["options"]["num_predict"]
            check(0 < rec["eval_count"] <= n_pred,
                  f"server {path}: eval_count {rec['eval_count']} not in "
                  f"(0, {n_pred}]")
            if path == "/api/generate":
                check(len(rec["context"]) == rec["prompt_eval_count"]
                      + rec["eval_count"], f"server {path}: context length")
            finals.append(rec)
        # Determinism: the same greedy request twice, alone, gives the
        # same context ids.
        ctx = [json.loads(_post(url + reqs[0][0], reqs[0][1])[1])["context"]
               for _ in range(2)]
        check(ctx[0] == ctx[1], "server: greedy reruns differ")
        launches = {"quant_matmul": quant_matmul.launches,
                    "paged_attention_append": paged_attention_append.launches}
        print(f"server: 6 concurrent requests answered in {burst_s:.2f} s, "
              f"greedy rerun identical ({len(ctx[0])} context ids); kernel "
              f"launches on the main path: {launches}")
        for name, n in launches.items():
            check(n > 0, f"server: kernel {name} was never launched")
            results[name]["launches"] = n
        ttft = sorted(r["prompt_eval_duration"] / 1e6 for r in finals)
        toks = sum(r["eval_count"] for r in finals)
        per_req = [r["eval_count"] / (r["eval_duration"] / 1e9)
                   for r in finals if r["eval_duration"] > 0]
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        step_ms = next((line.split()[-1] for line in metrics.splitlines()
                        if line.startswith("decode_wall_ms ")), "?")
        print(f"server: TTFT p50 {ttft[len(ttft) // 2]:.1f} ms (max "
              f"{ttft[-1]:.1f} ms) over 6 requests; decode {toks} tokens in "
              f"{burst_s:.2f} s = {toks / burst_s:.1f} tok/s aggregate, "
              f"{sorted(per_req)[len(per_req) // 2]:.1f} tok/s per request "
              f"(p50); decode step p50 {step_ms} ms at B=8")
    finally:
        server.stop()
        engine.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="build,kernel,step,server",
                    help="comma-separated phases to run")
    phases = set(ap.parse_args().only.split(","))
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke test runs on the card only)",
              flush=True)
        return 2
    try:
        import p2p_llm_chat_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable ({e}); run from the "
              "repository root", flush=True)
        return 2
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {}
    t0 = time.monotonic()
    try:
        if "build" in phases:
            phase_build()
        if "kernel" in phases:
            print("kernel phase:", flush=True)
            phase_kernel_a(results)
            phase_kernel_b(results)
            print(f"kernel phase done ({time.monotonic() - t0:.0f} s)",
                  flush=True)
        if "step" in phases:
            phase_step()
            print(f"step phase done ({time.monotonic() - t0:.0f} s)",
                  flush=True)
        if "server" in phases:
            check("kernel" in phases, "the server phase reports into the "
                  "kernel phase's results; run both")
            phase_server(results)
            print(f"server phase done ({time.monotonic() - t0:.0f} s)",
                  flush=True)
        if "profile" in phases:
            phase_profile()
            print(f"profile phase done ({time.monotonic() - t0:.0f} s)",
                  flush=True)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print(f"card: {card_line()}", flush=True)
    if results:
        print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
