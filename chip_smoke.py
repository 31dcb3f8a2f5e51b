#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (p2p_llm_chat_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. build  — nvcc builds every CUDA kernel from csrc/ (in parallel);
2. kernel — each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with CUDA-event timings beside the bound:
   kernel A (w8a16 on tensor cores) exact on all 256 int8 values, at every
   row count around its 16-, 64- and 128-row tiles on ragged shapes, at the
   llama3.1-8b shapes with bitwise reruns and rows independent of M, timed
   per decode step and per 256-row prefill chunk, kernel B (paged decode
   attention on tensor cores) in its append mode (current token seeded)
   and its pool mode (write-then-attend), int8 and bf16 pools, on ragged
   geometries (rep 1-8, D 32-128, page sizes 16, 48 and 64, windows up
   to 4096, NaN in every dead slot), each case bitwise against a rerun,
   its rows' B = 1 calls and a window twice as wide, timed per
   llama3.1-8b step as timed and on the device (CUDA graphs), kernel B's
   verify mode (speculative verify: S positions per row over the pool
   plus their own k/v under a chain or tree mask) on the same ragged
   geometries with S 2, 5, 8, 16 and 64, at a session wake's S = 128
   and 256 and at a drafter feed's S = 512, with the same bitwise checks,
   timed per llama3.1-8b verify at S = 8 and per wake at R = 1, S = 256
   beside its bound and SDPA over the pre-gathered window plus the block,
   with the split kernel and the merge apart under torch.profiler, kernel C (w4a16 on tensor cores)
   exact on all 256 byte values,
   on ragged shapes that run every row tile and both of its routes, at
   the mixtral-8x7b and llama3.1-8b int4 shapes with bitwise reruns and
   rows independent of M, timed per decode step and per 256-row chunk,
   the expert grids of kernels A and C at mixtral-8x7b's expert shapes
   (ragged buckets, bitwise reruns, decode and chunk buckets timed),
   kernel D (causal prefill attention) on
   whole prompts (the embed path's batches among them: R = 8 and 16 at
   S = 256 and 2048), the 256-wide chunks of a 2048 prompt (rows bitwise
   equal to the whole prompt's), a co-pilot-template suffix and ragged
   shapes that run every q tile its plan picks, timed whole and in chunks
   beside SDPA and the bound, with its log-sum-exp at a ring hop's
   shapes (R = 2, 2048 over 2048, offsets 0 and 2048, 32 / 8 and 16 / 4
   heads: the output bitwise the launch's without it, timed both ways),
   and kernel E (w8a8 on int8 tensor cores:
   the TMA route and the ragged route, each bitwise against its plain
   version, alone and chained after the row quantization kernel, at the
   mm_micro and llama3.1-8b shapes, the TMA route's edges and the ragged
   route's shapes, reruns bitwise; the row scale of hard rows equal to
   numpy's f32 quotient), after which the mm_micro twin
   (p2p_llm_chat_tpu_torch/tools/mm_micro) runs once and prints its
   device and as-timed table; and A8, the dense KV path's attention
   (kernel B's pool and verify modes over a zero-copy identity pool view
   of the dense cache), at rep 1-8, D 64 and 128, max_seq 1024, 4096,
   1000 and 1100, ragged lengths with NaN past each row's, S = 5 chains
   and 8-node trees, chains of S = 16, 64, 256 and 512 at the drafter's
   feeds (B = 8, Hq 8 / Hkv 4, W = 1024, 2048 and 4096), each case bitwise against a rerun, its rows' B = 1
   calls and the whole cache as the window, and a session wake's
   attention (kernel B's verify mode on the waking rows {5} or {6, 1} of
   a llama3.1-8b cache of 8 x 4096, S = 64 and 256, W = 2048 and 4096,
   NaN past each row's length and in every row not waking) against the
   reference's attend_gqa over those rows, A8's decode mode with its
   log-sum-exp at sp decode's shard (B = 2, W = 2048, a row of 0 slots:
   output 0, lse -inf; the output bitwise the launch's without it,
   timed both ways), timed per llama3.1-8b step
   at W = 1024 and 4096 (and verify at S = 5, the wake at R = 1, S = 256,
   W = 2048) beside the bound and SDPA;
3. step   — one full-width decode step (depth cut to 2 layers, mixtral-8x7b's
   to 1) through the
   kernels on the card, against the same step through the plain path on
   the CPU (same weights, same pool): llama3.1-8b int8 over an int8 pool
   and over a bf16 pool through the write-then-attend branch
   (PAGED_ATTN_IMPL=kernel), then mixtral-8x7b int8 and int4; for the
   int8 models also a prefill through kernel D against the CPU's plain
   prefill, a chunked prefill against the whole-prompt prefill on the
   card, and ``embed_pooled`` of six texts (R = 2 at S = 256, R = 4 at
   S = 128: kernel A or the expert grid, and kernel D) against the CPU's
   plain embedding at cosine >= 0.999; and for each, the scheduler's decode programs at B = 8: the
   CUDA graphs of every (window, K) captured as the warmup does, the
   K = 1 replay bitwise equal to the eager step with the same launch
   counts, the K = 4 replay bitwise equal to four K = 1 replays and to
   eager ``decode_fused`` (greedy and sampled rows, one EOS mid-burst);
   each step also runs the speculative verify forwards
   (``verify_step_paged`` on its branch, ``verify_tree_paged`` on the
   gather branch) against the CPU's plain path (logits within STEP_TOL,
   the written block within it, the rest of the pool bitwise unchanged)
   and, on 2-layer quote weights in the scheduler's state, a greedy
   verify against K + 1 sequential steps, a tree tick whose sibling is
   used and moved (copy_slot) bitwise onto the accepted slot, and the
   window's spec graph bitwise against the eager spec tick; on llama int8
   and mixtral int4 also a session wake's forward (R = 1, S = 256,
   ``verify_step_paged(last_idx=...)``) against the CPU; then the dense
   path (``step_dense``, llama int8 and mixtral int4 over a bf16 dense
   cache): ``decode_step``, ``verify_step`` (llama) and ``verify_tree``
   against the CPU's plain path, ``decode_fused`` at K = 4 bitwise equal
   to 4 steps, and the scheduler's dense decode graphs (K = 1 replay
   bitwise equal to the eager step, K = 4 to four K = 1 replays); and
   the int8 pool's writes, card against CPU, bitwise; then
   ``step_parallel``, the pipeline and ring programs on four rank
   processes (``chip_smoke.py --par-rank``) over gloo on the one card:
   pp = 2, sp = 2, sp 2 x tp 2 (llama3.1-8b cut to 4 layers) and sp 2 x
   ep 2 (mixtral-8x7b cut to 2), int8 quote weights, each against the
   single-rank prefill and decode on the card (logits and k cache within
   PAR_TOL, greedy tokens equal, decode logits bitwise equal on every
   rank, kernels D and B with their log-sum-exp on the ring's legs);
4. server — the port's engine behind its Ollama front on localhost
   answers 7 concurrent requests (one 1500-token prompt, one co-pilot
   request) and two greedy reruns, five times: llama3.1-8b int8 with the
   reference's admission defaults (chunked prefill at 256, the prefix
   cache) and with SERVE_PREFILL_CHUNK=0, llama3.1-8b int8 over a bf16
   pool with PAGED_ATTN_IMPL=kernel (kernel B's pool mode only), then
   mixtral-8x7b int8 (32 layers, int8 paged KV) and int4 (32 layers, the
   bf16 dense cache: A8's decode mode, kernel B's paged modes never).
   Before each
   burst every kernel's launch counter is zeroed; after it, the kernels of
   that path must have grown, the other decode branch's attention kernel
   must not have, the co-pilot request must have taken the prefix path,
   the long prompt must have admitted in chunks where chunking is on, and
   decode must have run fused ticks (``decode_fused_mean_k`` > 1 on
   ``/metrics``) replayed from CUDA graphs (the launch counters grow by
   what each replay's capture recorded). Each server also: reads
   ``decode_device_ms`` (the warmup's probe) beside the CUDA-event time of
   the same K = 1 graph (within 15%) and the loop-stall gauges; answers
   ``/api/embed`` (2 texts: R = 2, S = 256; 5 texts, one of 1,500 bytes:
   R = 8, S = 2048; 12 texts: R = 16, S = 256) and ``/api/embeddings`` on
   the idle server (counters zeroed: kernel A or C and kernel D must
   launch; unit vectors of the hidden size), greedy reruns while an
   R = 8, S = 2048 embed is in flight (equal to the idle reruns), then
   the probe's graph replayed during an embed and the same embeds from a
   second thread during a rerun of the burst, with the loop on its own
   stream and moved to one of the other end of the priority range
   (cosine >= 0.9999 to the idle ones, greedy rerun unchanged; replay
   times, and decode p50 without embeds and under each priority,
   printed); recovers
   from ``serve.scheduler.dispatch`` and ``serve.engine.readback`` armed
   ``raise*1`` (a streamed request ends in an error record, one
   ``failpoint_hits_total``, greedy rerun unchanged); and holds a pinned
   ``X-Graft-Trace`` request's ``api.request`` and ``sched.*`` spans on
   ``/admin/trace``, with ``/admin/trace/dump`` writing its file. The
   first llama3.1-8b server also serves ``SERVE_PROFILE_PORT``: after its
   readings a third greedy rerun and a chunked prompt run under a 2 s
   capture of the loop, whose trace must name kernels A, B and D by their
   ``__global__`` names and the ``sched.tick`` and ``sched.chunk`` ranges;
   then the chat plane's co-pilot leg: that server's tensors take
   full-width quote weights in place (models/synth.quote_params, whose
   greedy output is printable text) and its co-pilot prefix is built
   anew; the port's directory, relay, two nodes (B reachable only
   through the relay's circuit) and two UIs in front of that server,
   counters zeroed: a message A -> B, B's
   ``/api/suggest`` equal to the server's greedy ``/api/generate`` of the
   same payload and ``/api/suggest/stream`` concatenating to it, the
   suggestion accepted back to A's inbox, kernels A, B (append) and D
   launched, the prefix path taken, all within 20 s; its readings (the
   UI's added ms, first streamed delta, send -> inbox each way, the
   relay's pump, the crypto in use) beside the card line;
5. server_spec — four SERVE_SPEC=4 servers on full-width quote weights
   (models/synth.quote_params): llama3.1-8b int8 with the tree default
   (8 nodes) and linear over an int8 pool, linear over a bf16 pool with
   PAGED_ATTN_IMPL=kernel (the write-then-attend verify through kernel
   B's pool mode), and mixtral-8x7b int4 with the tree default: each
   answers a 7-request burst with acceptance (``serve_spec_accepted_total``
   > 0, ``serve_spec_accepted_per_dispatch`` > 1) and the verify mode's
   launches counted (the pool mode's on write-then-attend), its greedy
   answers equal to the same server's with speculation off (the burst
   rerun for readings: served tok/s, per-request rate, accepted drafts
   per verify dispatch), and a ``serve.scheduler.dispatch`` fault inside
   a spec tick recovered with the greedy rerun unchanged;
6. server_tier — the KV tier: two 32-layer llama3.1-8b int8 engines in
   one process (prefill and decode class, ``SERVE_KV_HOST_GB=8``) behind
   their fronts: a resident and a parked wake with bitwise-equal greedy
   streams through kernel B's verify mode and kernel A (counters zeroed
   before), the same turn admitted cold, the park copy's and the wake
   forward's times, prefix export/import, migration (park_all, export,
   pull-import, forget), the ``serve.kv_tier.*`` failpoints and pool
   pressure; then the port's replica router (serve/router.py) over the
   two fronts: a new 1500-token conversation through its disaggregated
   handoff (kernel D on A, kernel B's verify mode on B, the stream equal
   to A's wake of the same prefill), the follow-up turn woken on B by
   affinity, a drain of B through the router migrating B's sessions to
   A (the next turn equal to an unmoved twin's), the fleet's ``/metrics``
   under ``replica="0|1"``, and the entry in router mode
   (``SERVE_ROUTER_UPSTREAMS``) in a process that sees no card, answering
   alike and exiting 0 on SIGTERM; then the same
   over the dense cache (``SERVE_KV=dense``, one set of weights for all
   four engines): sessions parked at finish, two woken turns equal to
   each other and to the same turn admitted cold, through kernel B's
   verify mode on the waking rows of the cache's identity view, kernel A
   and A8's decode mode, migration, the handoff equal to a cold run, the
   failpoints; with each park's stall in the serving loop, the park copy
   and the wake's upload + install, and the wake forward at S = 64 and
   256;
7. server_ckpt — a checkpoint directory written here into a temporary
   directory (removed at exit): llama3.1-8b at full width and depth,
   bf16 shards of at most 5 GB and their index, each tensor drawn on the
   card from its own seeded generator, and a llama3-shaped BPE tokenizer
   (1024 merges trained in pure Python on this docstring and the burst's
   texts, llama3's specials at 128000-128255). ``CKPT_DIR`` at
   ``SERVE_QUANT=int8``: the served tree bitwise equal to the port's
   quantize + fuse of the same weights drawn again on the card and to
   the reference's numpy arithmetic (layers 0 and 31, the head); the
   burst (its chat request a co-pilot message in the llama3 template,
   whose header and eot ids must reach the context) and greedy reruns
   through kernels A, B and D; the prefix path taken exactly when the
   ids extend the template's; the native BPE path against the Python
   one. Then ``SERVE_QUANT=""`` (the shards' bits, one request through B
   and D), and a 2-layer mixtral-8x7b directory loaded at int4 (expert
   stacks and router bitwise against quantize4 + fuse on the card);
8. server_multi — that directory at int4 as ``llama3.1`` beside a
   random llama3.2-1b (``small``, head_dim 64) behind one front:
   ``/readyz`` 503 until both engines have warmed, the tags on
   ``/api/tags``, ``/api/ps``, ``/api/show`` and ``/metrics``, each tag's
   burst alone (kernel C; B and D at head_dim 64) and both at once with
   equal greedy answers, an embed to ``small`` during a ``llama3.1``
   rerun. Both print the checkpoint write, load and boot walls, the
   per-layer quantize ms and the serving readings;
9. server_dense — ``SERVE_KV=dense`` (the reference's default):
   llama3.1-8b int8 over a bf16 dense cache of 8 x 4096, the burst and
   greedy reruns with counters zeroed (kernels A, D and A8's decode mode
   launched, kernel B's paged modes never; fused ticks), then the same
   weights over a bf16 page pool under ``PAGED_ATTN_IMPL=kernel``: the
   greedy answers equal;
10. server_draft — the resident draft model (``SERVE_KV=dense
   SERVE_SPEC=4``, tree of 8): the 8B drafting for itself on quote
   weights (model-source acceptance, A8's verify mode, greedy answers
   equal with speculation off), then ``SERVE_DRAFT=draft-400m``; each
   prints the drafter's KV GB, its ms per draft dispatch and its
   acceptance.

Optional (``--only build,profile``): ``profile`` — one 32-layer decode
step at B=8, W=1020 of llama3.1-8b int8 (int8 pool, and bf16 pool through
the write-then-attend branch) and of mixtral-8x7b int8 and int4, eager
(the bare step, and the step with the device sampler) and replayed from
the scheduler's K = 1 and K = 4 CUDA graphs, each timed with CUDA events
and broken down by kernel with torch.profiler, with the device's idle
share; and one 32-layer llama3.1-8b int8 prefill of a
2048-token prompt, whole and as 8 chunks of 256, broken down the same way.

Prints the card's name and power limit early, a ``{"kernels": [...]}``
JSON line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--only build,kernel`` runs a subset (``--only
build,kernel_d,profile_prefill`` iterates on one kernel; ``--only
build,kernel_b_verify,step,server_spec`` on speculation; ``--only
build,kernel_b_verify,server_tier`` on the KV tier; ``--only
build,server_ckpt,server_multi`` on checkpoints and the multi front;
``--only build,kernel_dense,step_dense,server_dense,server_draft`` on
the dense path and the drafter; ``--only
build,kernel_dense,server_tier`` on the KV tier over both layouts;
``--only build,kernel_b_verify,server_multihost,server_llama`` on
``SERVE_TP``'s KV tier and session wire, the multi-process plane and the
profiler server; ``--only build,kernel_d,kernel_dense,step_parallel`` on
the pipeline and ring programs).
Exits non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger
# of its bytes over the memory rate and its operations over the bf16 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
L2_BYTES = 50 * 2 ** 20

A_TOL = 1e-2        # of max|plain|: one bf16 rounding of the output (2^-8)
#                     either side + f32 summation order
B_TOL = 1e-2        # of max|plain|: the kernel rounds the unnormalised
#                     probabilities (times the v scales on int8 pools) to
#                     bf16 for p.v and divides after; the plain versions
#                     round the same (append mode), the normalised ones
#                     (the gather impl) or none (the kernel and flash
#                     impls' f32 p.v): 2^-9 relative per term at most;
#                     plus one bf16 rounding of the output either side
#                     and the f32 summation order
C_TOL = 1e-2        # of max|plain|: as A_TOL (the plain version sums the
#                     dequantized f32 weight in another order)
D_TOL = 1e-2        # of max|plain|: the plain version rounds the softmax-
#                     normalised probabilities to bf16 for p.v, the kernel
#                     rounds the unnormalised ones and divides after (2^-8
#                     relative each), plus one bf16 rounding of the output
#                     and the f32 summation order
STEP_TOL = 5e-2     # of max|logits|: bf16 activations through 2 layers,
#                     rounded at different places on the two paths
LSE_ATOL = 1e-3     # absolute, natural log: kernels D and B's log-sum-exp
#                     against the plain f32 logsumexp of the same bf16
#                     inputs (f32 scores summed in another order, exp2f):
#                     a merge weight exp(lse) off by at most 0.1%
PAR_TOL = 5e-2      # of max|oracle|: step_parallel's logits and k cache
#                     against the single-rank oracle on the card, bf16
#                     activations through 4 layers (2 for mixtral), the
#                     hops / shards merged in f32 from bf16 partials where
#                     the oracle attends in one call


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS
             ) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / peak
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


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device ms per call of ``fn(i)``: ``n`` calls captured in one CUDA
    graph and replayed, so the host's cost per call is left out (the
    wrappers' checks, allocations and launches; ``time_ms`` of small calls
    measures that instead)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                    # first launch (opt-ins) outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    return time_ms(lambda _i: graph.replay(), reps) / n


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
            if ("registers" in line or "spill" in line
                    or (name in ("quant_mm", "quant_mm4",
                                 "prefill_attention", "paged_attention",
                                 "w8a8_mm")
                        and "entry function" in line)):
                print(f"  ptxas {name}: {line.strip()}")


# -- phase 2: kernels ---------------------------------------------------------

A_SHAPES = {          # llama3.1-8b projections: (H, O, launches per step)
    "wqkv": (4096, 6144, 32),
    "wo": (4096, 4096, 32),
    "wgu": (4096, 28672, 32),
    "w_down": (14336, 4096, 32),
    "lm_head": (4096, 128256, 1),
}
A_SHARD_SHAPES = {    # a tp = 2 rank's shards of them (serve/tp.py): (H, O)
    "wqkv_r": (4096, 3072),
    "wo_r": (2048, 4096),
    "wgu_r": (4096, 14336),
    "w_down_r": (7168, 4096),
    "lm_head_r": (4096, 64128),
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

    def rand_x(M, H):
        return torch.randn((M, H), generator=gen, device=dev).to(
            torch.bfloat16)

    # The int8 -> bf16 conversion is exact for all 256 values: identity
    # rows against a weight holding every value in every row give the
    # weight back exactly (unit scales), through the 16- and 128-row tiles.
    vals = (torch.arange(256, device=dev)[:, None]
            + torch.arange(256, device=dev)[None, :]) % 256 - 128
    q_all = vals.to(torch.int8).contiguous()
    s_one = torch.ones((1, 256), device=dev)
    for M in (16, 256):
        eye = torch.eye(256, device=dev)[:M].to(torch.bfloat16).contiguous()
        out = quant_matmul(eye, q_all, s_one)
        torch.cuda.synchronize()
        check(torch.equal(out.float(), q_all[:M].float()),
              f"kernel A: int8 -> bf16 not exact at M={M}")
    print("  kernel A: all 256 int8 values exact through the bf16 tiles "
          "(M=16 and M=256)")

    # Ragged shapes at a layer offset, at every row count around the row
    # tiles (16, 64, 128): O not a multiple of 16 (masked weight loads), H
    # not a multiple of 8 (masked x loads), both, neither; then an x whose
    # base is not 16-byte aligned (masked x loads at H % 8 == 0).
    ragged_m = (1, 8, 15, 16, 17, 63, 64, 65, 255, 256, 257, 512)
    for (H, O) in ((100, 200), (128, 256), (128, 136), (100, 256)):
        qt = rand_q(H, O, L=2)
        for M in ragged_m:
            check_case(f"ragged M={M} H={H} O={O} layer=1", rand_x(M, H),
                       qt.q, qt.s, 1)
    qt = rand_q(128, 256, L=2)
    flat = torch.randn((1 + 65 * 128,), generator=gen, device=dev).to(
        torch.bfloat16)
    for M in (5, 17, 65):
        x = flat[1:1 + M * 128].view(M, 128)
        check(x.data_ptr() % 16 != 0, "misaligned case is aligned")
        check_case(f"ragged M={M} H=128 O=256 x at +2 bytes", x, qt.q,
                   qt.s, 1)

    # A tensor-parallel rank's shard shapes: new K (2048, 7168) and
    # split-K plans, lm_head's 64128 columns.
    for name, (H, O) in A_SHARD_SHAPES.items():
        qt = rand_q(H, O, L=None if name == "lm_head_r" else 2)
        for M in (32, 256):
            check_case(f"tp2 shard {name} M={M} H={H} O={O}", rand_x(M, H),
                       qt.q, qt.s, None if name == "lm_head_r" else 1)
        del qt

    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    chunk = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
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
        for M in (1, 8, 32, 256, 512):
            check_case(f"{name} M={M} H={H} O={O}", rand_x(M, H), qt.q,
                       qt.s, layer_of(1))
        # Determinism and row independence: a rerun is bitwise the same,
        # and the first rows of a 256-row call are bitwise the calls on
        # those rows alone (the K order and split plan never depend on M).
        x = rand_x(256, H)
        full = quant_matmul(x, qt.q, qt.s, layer_of(1))
        check(torch.equal(full, quant_matmul(x, qt.q, qt.s, layer_of(1))),
              f"kernel A {name}: reruns differ")
        for M in (1, 8, 17):
            check(torch.equal(full[:M], quant_matmul(
                x[:M].contiguous(), qt.q, qt.s, layer_of(1))),
                f"kernel A {name}: rows of the M=256 call differ from the "
                f"M={M} call")
        print(f"  kernel A {name}: reruns bitwise equal; rows of M=256 "
              f"bitwise equal to the M=1, 8, 17 calls")
        # Prefill-shaped calls: a 256-row chunk (the scheduler's default
        # SERVE_PREFILL_CHUNK) and a 512-row whole prompt.
        for M in (256, 512):
            x = rand_x(M, H)
            ms = time_ms(lambda i: quant_matmul(x, qt.q, qt.s, layer_of(i)),
                         10)
            b_ms, kind = bound_ms(H * O + 4 * O + 2 * M * (H + O),
                                  2.0 * M * H * O)
            lib_note = ""
            if M == 256 and name != "lm_head":
                wl = [dequantize(type(qt)(qt.q[i], qt.s[i]), torch.bfloat16)
                      for i in range(nl)]
                lib = time_ms(lambda i: torch.matmul(x, wl[i % nl]), 10)
                del wl
                lib_note = f"; torch.matmul on pre-dequantized bf16 " \
                           f"{lib * 1e3:.1f} us"
                chunk["ms"] += per_step * ms
                chunk["bound_ms"] += per_step * b_ms
                chunk["library_ms"] += per_step * lib
            print(f"  kernel A {name} M={M}: {ms * 1e3:.1f} us (bound "
                  f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of bound; "
                  f"{2.0 * M * H * O / ms / 1e9:.1f} TFLOP/s){lib_note}")
            if M == 512 and name != "lm_head":   # 1 lm_head row per prompt
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
          f"{step['ms']:.3f} ms vs bound {step['bound_ms']:.3f} ms; "
          f"torch.matmul on pre-dequantized bf16 {step['library_ms']:.3f} ms")
    print(f"  kernel A per 256-row prefill chunk (128 layer launches): "
          f"{chunk['ms']:.3f} ms vs bound {chunk['bound_ms']:.3f} ms "
          f"(operations); torch.matmul on pre-dequantized bf16 "
          f"{chunk['library_ms']:.3f} ms; the 128 layer launches of a "
          f"512-row prompt: {prefill_ms:.3f} ms")
    results["quant_matmul"] = dict(
        name="quant_matmul", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/quant_mm.cu",
        replaces="p2p_llm_chat_tpu/ops/quant_mm.py:241",
        also_replaces="p2p_llm_chat_tpu/ops/quant_mm.py:383",
        max_abs_err=worst_abs, max_rel_err=worst_rel,
        bound_by=max(bound_kind, key=bound_kind.get),
        scope="one llama3.1-8b decode step at B=8: 32 x (wqkv, wo, wgu, "
              "w_down) + lm_head = 129 launches; library_ms is torch.matmul "
              "on pre-dequantized bf16 weights; prefill_chunk_* are the 128 "
              "layer launches of one 256-row chunk (bound by operations)",
        **{k: round(v, 4) for k, v in step.items()},
        **{f"prefill_chunk_{k}": round(v, 4) for k, v in chunk.items()})


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


def _b_call(cache, q, kc, vc, pages, layer, impl=None):
    """Kernel B through its wrapper: append mode with ``kc``/``vc``, pool
    mode (``impl``) without."""
    from p2p_llm_chat_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_append)
    if kc is not None:
        return paged_attention_append(q, kc, vc, cache, cache.lengths, layer,
                                      pages=pages)
    return paged_attention(q, cache.k, cache.v, cache.page_table,
                           cache.lengths, layer, pages=pages, impl=impl,
                           k_scale=cache.k_scale, v_scale=cache.v_scale)


def _b_plain(cache, q, kc, vc, pages, layer, impl=None):
    from p2p_llm_chat_tpu_torch.ops.paged_attention import (
        paged_attention_append_reference, paged_attention_plain)
    if kc is not None:
        return paged_attention_append_reference(q, kc, vc, cache,
                                                cache.lengths, layer,
                                                pages=pages)
    return paged_attention_plain(q, cache.k, cache.v, cache.page_table,
                                 cache.lengths, layer, pages=pages,
                                 impl=impl, k_scale=cache.k_scale,
                                 v_scale=cache.v_scale)


def _b_case(label, cache, q, kc, vc, pages, layer=1, impl=None) -> float:
    """One kernel B case: within B_TOL of the plain version, a rerun
    bitwise equal, and each row bitwise equal to its own B = 1 call and
    to the call over a window of 2 ``pages`` (the extra table entries
    point at page 0, NaN/Inf garbage). Returns the absolute error."""
    import dataclasses
    import torch
    out = _b_call(cache, q, kc, vc, pages, layer, impl)
    err = _rel_err(label, out, _b_plain(cache, q, kc, vc, pages, layer,
                                        impl), B_TOL)
    check(torch.equal(_b_call(cache, q, kc, vc, pages, layer, impl), out),
          f"{label}: a rerun differs from the first run")
    pt = cache.page_table[:, :pages]
    wide = dataclasses.replace(cache, page_table=torch.cat(
        [pt, torch.zeros_like(pt)], 1))
    check(torch.equal(_b_call(wide, q, kc, vc, 2 * pages, layer, impl), out),
          f"{label}: rows differ at a window of {2 * pages} pages")
    for b in range(q.shape[0]):
        one = dataclasses.replace(
            cache, page_table=cache.page_table[b:b + 1].contiguous(),
            lengths=cache.lengths[b:b + 1].contiguous())
        row = lambda t: None if t is None else t[b:b + 1].contiguous()
        check(torch.equal(_b_call(one, row(q), row(kc), row(vc), pages,
                                  layer, impl), out[b:b + 1]),
              f"{label}: row {b} differs between B = 1 and B = "
              f"{q.shape[0]}")
    return err


def _b_timing(mode: str, cache, q, kc, vc, pages, L, impl=None) -> dict:
    """One llama3.1-8b step of kernel B (32 layer launches, rotating over
    the pool's ``L`` layers so the reads stay cold in L2): CUDA events
    back to back (``ms``, the host's cost per call included) and device
    time replayed from a CUDA graph (``device_ms``), beside the plain
    version and SDPA over an already-gathered (dequantized) window with
    the current token appended in append mode, the gather not timed."""
    import torch
    import torch.nn.functional as F
    B, Hq, D = q.shape
    Hkv, ps = cache.k.shape[3], cache.page_size
    W = pages * ps
    call = lambda i: _b_call(cache, q, kc, vc, pages, i % L, impl)
    ms = time_ms(call, 96, warmup=L)
    dev = graph_ms(call, n=2 * L)
    plain = time_ms(lambda i: _b_plain(cache, q, kc, vc, pages, i % L,
                                       impl), 8, warmup=1)
    kw, vw = [], []
    idx = cache.page_table[:, :pages].long()
    for layer in range(L):
        kl = cache.k[layer][idx].reshape(B, W, Hkv, D).float()
        vl = cache.v[layer][idx].reshape(B, W, Hkv, D).float()
        if cache.quantized:
            sk = cache.k_scale[layer][idx][..., :ps].transpose(1, 2)
            sv = cache.v_scale[layer][idx][..., :ps].transpose(1, 2)
            kl = kl * sk.reshape(B, Hkv, W).transpose(1, 2)[..., None]
            vl = vl * sv.reshape(B, Hkv, W).transpose(1, 2)[..., None]
        if kc is not None:
            kl = torch.cat([kl, kc.float()[:, None]], 1)
            vl = torch.cat([vl, vc.float()[:, None]], 1)
        kw.append(kl.to(torch.bfloat16).permute(0, 2, 1, 3)
                  .repeat_interleave(Hq // Hkv, 1))
        vw.append(vl.to(torch.bfloat16).permute(0, 2, 1, 3)
                  .repeat_interleave(Hq // Hkv, 1))
    q4 = q[:, :, None, :]
    sdpa = lambda i: F.scaled_dot_product_attention(q4, kw[i % L], vw[i % L])
    lib = time_ms(sdpa, 96, warmup=L)
    lib_dev = graph_ms(sdpa, n=2 * L)
    del kw, vw
    tokens = B * W
    el = 1 if cache.quantized else 2
    nbytes = (2 * tokens * Hkv * D * el
              + (2 * tokens * Hkv * 4 if cache.quantized else 0)
              + 2 * q.numel() * 2 + 4 * B * (1 + pages)
              + (0 if kc is None else (kc.numel() + vc.numel()) * 2))
    b_ms, kind = bound_ms(nbytes, 4.0 * tokens * Hq * D)
    print(f"  kernel B {mode} {'int8' if cache.quantized else 'bf16'} B={B} "
          f"W={W} (8B geometry), per layer: {ms * 1e3:.1f} us as timed, "
          f"{dev * 1e3:.1f} us on the device (bound {b_ms * 1e3:.1f} us, "
          f"{kind}; {b_ms / dev:.0%} of bound; host gap "
          f"{(ms - dev) * 1e3:.1f} us); plain {plain * 1e3:.1f} us; SDPA on "
          f"a pre-gathered window (gather excluded) {lib * 1e3:.1f} us as "
          f"timed, {lib_dev * 1e3:.1f} us on the device")
    return dict(ms=round(32 * ms, 4), device_ms=round(32 * dev, 4),
                plain_ms=round(32 * plain, 4), bound_ms=round(32 * b_ms, 4),
                library_ms=round(32 * lib, 4),
                library_device_ms=round(32 * lib_dev, 4), bound_by=kind)


def phase_kernel_b(results: dict) -> None:
    """Kernel B's append mode (TPU kernel rows 3 and 5) against its plain
    version: int8 and bf16 pools at rep 2, 4 and 8 (D 32 and 128; the int8
    pool also at a tp = 2 rank's Hq 16, Hkv 4), windows
    of 64, 1000 and 4096 tokens with ragged lengths reaching into the
    NaN-filled page 0, page sizes 16 and 48 (chunks straddle pages,
    slices start mid-page); each case also bitwise against a rerun, its
    rows' B = 1 calls and a window twice as wide. Timed per 32-layer
    llama3.1-8b step at B = 8, W = 1024 on an int8 pool."""
    from p2p_llm_chat_tpu_torch.ops import _build
    from p2p_llm_chat_tpu_torch.ops import paged_attention as pa
    lib = _build.load("paged_attention", pa._bind)
    print("  kernel B split kernel, dynamic shared memory per block: "
          + ", ".join(f"{'int8' if qz else 'bf16'} D={D} "
                      f"{lib.paged_split_smem(qz, D)} B"
                      for qz in (1, 0) for D in (32, 64, 128)))
    worst = 0.0
    for quantized in (True, False):
        pool = "int8" if quantized else "bf16"
        for (Hq, Hkv, D) in ((4, 2, 32), (32, 8, 128), (64, 8, 128)):
            for W in (64, 1000, 4096):
                # Ragged: a full window, a partial last page, one short
                # row, a single token; windows past the allocation read
                # the NaN-filled garbage page 0.
                lengths = [W, max(1, W - 37), max(1, W // 3 + 5), 1]
                cache, q, kc, vc, pages = _paged_case(quantized, Hq, Hkv, D,
                                                      W, lengths, seed=W)
                worst = max(worst, _b_case(
                    f"kernel B {pool} Hq={Hq} Hkv={Hkv} D={D} W={W} "
                    f"lengths={lengths}", cache, q, kc, vc, pages))
                del cache
        if quantized:
            # A tp = 2 rank's heads of llama3.1-8b (serve/tp.py).
            for W in (64, 1000, 4096):
                lengths = [W, max(1, W - 37), max(1, W // 3 + 5), 1]
                cache, q, kc, vc, pages = _paged_case(True, 16, 4, 128, W,
                                                      lengths, seed=W + 1)
                worst = max(worst, _b_case(
                    f"kernel B int8 tp2 rank Hq=16 Hkv=4 D=128 W={W} "
                    f"lengths={lengths}", cache, q, kc, vc, pages))
                del cache
        for ps in (16, 48):
            lengths = [1000, 300, 17, 1]
            cache, q, kc, vc, pages = _paged_case(quantized, 32, 8, 128, 1000,
                                                  lengths, ps=ps, seed=ps)
            worst = max(worst, _b_case(
                f"kernel B {pool} Hq=32 Hkv=8 D=128 ps={ps} W={pages * ps} "
                f"lengths={lengths}", cache, q, kc, vc, pages))
            del cache
    B, W, Hq, Hkv, D, L = 8, 1024, 32, 8, 128, 8
    cache, q, kc, vc, pages = _paged_case(True, Hq, Hkv, D, W, [W] * B, L=L,
                                          seed=99, nan_page0=False)
    t = _b_timing("append", cache, q, kc, vc, pages, L)
    results["paged_attention_append"] = dict(
        name="paged_attention_append", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/paged_attention.cu",
        replaces="p2p_llm_chat_tpu/ops/paged_attention.py:993",
        max_abs_err=worst,
        scope="one llama3.1-8b decode step at B=8, W=1024, int8 pool: 32 "
              "launches (one per layer); device_ms replays them from a "
              "CUDA graph; library_ms is SDPA over an already-gathered "
              "dequantized window, excluding the gather", **t)


def _poison_dead(cache, lengths) -> None:
    """NaN (int8 pools: NaN k scales, Inf v scales) in every slot of each
    row's own pages at or past its length: never read by the kernel."""
    ps = cache.page_size
    pt = cache.page_table.cpu()
    for b, n in enumerate(lengths):
        for pos in range(n, pt.shape[1] * ps):
            page = int(pt[b, pos // ps])
            if page == 0:
                break
            if cache.quantized:
                cache.k_scale[:, page, :, pos % ps] = float("nan")
                cache.v_scale[:, page, :, pos % ps] = float("inf")
            else:
                cache.k[:, page, pos % ps] = float("nan")
                cache.v[:, page, pos % ps] = float("nan")


def phase_kernel_b_pool(results: dict) -> None:
    """Kernel B's pool mode (write-then-attend: TPU kernel rows 4 and 6,
    and the gather impl's int8 pool) against the plain version of each
    impl: ragged geometries (rep 1, 3, 8; D 32, 64; lengths of 1, on a
    page boundary and short of a window that reaches past the live pages,
    with NaN in every dead slot), rep 8 at D 128 over a 4096-token window,
    page sizes 16 and 48, an int8 pool under impl="gather", and the
    llama3.1-8b step's bf16 pool; each case also bitwise against a rerun,
    its rows' B = 1 calls and a window twice as wide. Timed per 32-layer
    step beside its bound and SDPA over the already-gathered window."""
    worst = 0.0
    for (Hq, Hkv, D) in ((8, 8, 64), (12, 4, 32), (64, 8, 64)):
        # A single token, a page boundary, a partial last page, a row
        # whose window reaches past its live pages into NaN page 0.
        W = 300
        lengths = [1, 128, 257, 64]
        cache, q, _, _, pages = _paged_case(False, Hq, Hkv, D, W, lengths,
                                            seed=Hq + D)
        _poison_dead(cache, lengths)
        for impl in ("kernel", "flash"):
            worst = max(worst, _b_case(
                f"kernel B pool bf16 Hq={Hq} Hkv={Hkv} D={D} W={pages * 64} "
                f"lengths={lengths} impl={impl}", cache, q, None, None,
                pages, impl=impl))
        del cache
    for quantized in (True, False):
        impl = "gather" if quantized else "kernel"
        pool = "int8" if quantized else "bf16"
        for (Hq, W, ps, lengths) in ((32, 1024, 64, [1024, 64, 1000, 1]),
                                     (64, 4096, 64, [4096, 2100, 513, 1]),
                                     (32, 1000, 16, [1000, 300, 17, 1]),
                                     (32, 1000, 48, [1000, 300, 17, 1])):
            cache, q, _, _, pages = _paged_case(quantized, Hq, 8, 128, W,
                                                lengths, ps=ps, seed=7 + ps)
            _poison_dead(cache, lengths)
            worst = max(worst, _b_case(
                f"kernel B pool {pool} Hq={Hq} Hkv=8 D=128 ps={ps} "
                f"W={pages * ps} lengths={lengths} impl={impl}", cache, q,
                None, None, pages, impl=impl))
            del cache
    # llama3.1-8b step: B=8, W=1024 (the slot this step wrote included),
    # a bf16 pool of 32 layers; one launch per layer.
    B, W, Hq, Hkv, D, L = 8, 1024, 32, 8, 128, 32
    cache, q, _, _, pages = _paged_case(False, Hq, Hkv, D, W, [W] * B, L=L,
                                        seed=98, nan_page0=False)
    for layer in (0, 17, 31):
        worst = max(worst, _b_case(
            f"kernel B pool bf16 B={B} W={W} layer {layer} (8B step)", cache,
            q, None, None, pages, layer=layer, impl="kernel"))
    t = _b_timing("pool", cache, q, None, None, pages, L, impl="kernel")
    results["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/paged_attention.cu",
        replaces="p2p_llm_chat_tpu/ops/paged_attention.py:160",
        also_replaces="p2p_llm_chat_tpu/ops/paged_attention.py:1086",
        max_abs_err=worst,
        scope="kernel B pool mode (write-then-attend), one llama3.1-8b "
              "decode step at B=8, W=1024, bf16 pool: 32 launches; "
              "device_ms replays them from a CUDA graph; library_ms is "
              "SDPA over an already-gathered window, excluding the gather",
        **t)


def _verify_inputs(B, S, Hq, Hkv, D, seed, tree):
    """bf16 q_blk [B, S, Hq, D], k_blk / v_blk [B, S, Hkv, D] and, for a
    tree, a bool block mask [B, S, S] of random per-row trees (node i's
    parent a random earlier node, self included)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)
    mask = None
    if tree:
        cpu = torch.Generator().manual_seed(seed)
        mask = torch.zeros((B, S, S), dtype=torch.bool)
        for b in range(B):
            for i in range(S):
                mask[b, i, i] = True
                if i:
                    parent = int(torch.randint(0, i, (1,), generator=cpu))
                    mask[b, i] |= mask[b, parent]
        mask = mask.to(dev)
    return rand(B, S, Hq, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D), mask


def _v_call(cache, q, kb, vb, mask, pages, layer=1):
    from p2p_llm_chat_tpu_torch.ops.paged_attention import \
        paged_attention_verify_append
    return paged_attention_verify_append(q, kb, vb, cache, cache.lengths,
                                         layer, pages=pages, block_mask=mask)


def _v_case(label, cache, q, kb, vb, mask, pages) -> float:
    """One verify-mode case: within B_TOL of the plain version, a rerun
    bitwise equal, each row bitwise equal to its own B = 1 call and to
    the call over a window of 2 ``pages`` (the extra entries point at the
    NaN garbage page 0). Returns the absolute error."""
    import dataclasses
    import torch
    from p2p_llm_chat_tpu_torch.ops.paged_attention import \
        paged_attention_verify_append_reference
    out = _v_call(cache, q, kb, vb, mask, pages)
    err = _rel_err(label, out, paged_attention_verify_append_reference(
        q, kb, vb, cache, cache.lengths, 1, pages=pages, block_mask=mask),
        B_TOL)
    check(torch.equal(_v_call(cache, q, kb, vb, mask, pages), out),
          f"{label}: a rerun differs from the first run")
    pt = cache.page_table[:, :pages]
    wide = dataclasses.replace(cache, page_table=torch.cat(
        [pt, torch.zeros_like(pt)], 1))
    check(torch.equal(_v_call(wide, q, kb, vb, mask, 2 * pages), out),
          f"{label}: rows differ at a window of {2 * pages} pages")
    for b in range(q.shape[0]):
        one = dataclasses.replace(
            cache, page_table=cache.page_table[b:b + 1].contiguous(),
            lengths=cache.lengths[b:b + 1].contiguous())
        row = lambda t: None if t is None else t[b:b + 1].contiguous()
        check(torch.equal(_v_call(one, row(q), row(kb), row(vb), row(mask),
                                  pages), out[b:b + 1]),
              f"{label}: row {b} differs between B = 1 and B = "
              f"{q.shape[0]}")
    return err


def _verify_breakdown(call, L: int) -> dict:
    """Device ms per 32 layers of the verify mode's two launches, by
    torch.profiler over 2 L calls of ``call(i)``: the split kernel's span
    (the window slices and, since the redesign, the block's own slice)
    and the time the combine adds past the split's end. The combine is a
    programmatic dependent launch: its blocks are resident, waiting,
    while the split runs, so its own span would count the split again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(L):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(2 * L):
            call(i)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and "paged_" in e.name)
    split = tail = 0.0
    split_end = -math.inf
    for start, end, name in spans:
        if "combine" in name or "merge" in name:
            tail += max(0.0, end - max(start, split_end))
        else:
            split += end - start
            split_end = end
    scale = 32 / (2 * L) / 1e3
    check(split > 0 and tail > 0, "verify breakdown: torch.profiler saw "
          "no device time for the split kernel or the combine")
    return dict(split_device_ms=round(split * scale, 4),
                combine_device_ms=round(tail * scale, 4))


def _v_timing(B: int, S: int, W: int, seed: int) -> dict:
    """One 32-layer llama3.1-8b verify-mode call sequence at B rows, S
    block positions and a full window of W on an int8 pool (8 layers
    rotated so reads stay cold; chain mask): ms as timed and on the
    device (CUDA graph), the plain version, SDPA over a pre-gathered
    dequantized window plus the block under an explicit mask (the gather
    excluded), and the bound (bytes: the window, its scales, q, the block
    and out once; operations: q.k and p.v over the window and the chain's
    lower triangle of the block)."""
    import torch
    import torch.nn.functional as F
    from p2p_llm_chat_tpu_torch.ops.paged_attention import \
        paged_attention_verify_append_reference
    Hq, Hkv, D, L = 32, 8, 128, 8
    cache, _, _, _, pages = _paged_case(True, Hq, Hkv, D, W, [W] * B, L=L,
                                        seed=seed, nan_page0=False)
    q, kb, vb, _ = _verify_inputs(B, S, Hq, Hkv, D, seed - 1, False)
    call = lambda i: _v_call(cache, q, kb, vb, None, pages, i % L)
    ms = time_ms(call, 96 if S <= 64 else 32, warmup=L)
    dev = graph_ms(call, n=2 * L)
    parts = _verify_breakdown(call, L)
    plain = time_ms(lambda i: paged_attention_verify_append_reference(
        q, kb, vb, cache, cache.lengths, i % L, pages=pages), 8, warmup=1)
    ps = cache.page_size
    idx = cache.page_table[:, :pages].long()
    kw, vw = [], []
    for layer in range(L):
        kl = cache.k[layer][idx].reshape(B, W, Hkv, D).float()
        vl = cache.v[layer][idx].reshape(B, W, Hkv, D).float()
        sk = cache.k_scale[layer][idx][..., :ps].transpose(1, 2)
        sv = cache.v_scale[layer][idx][..., :ps].transpose(1, 2)
        kl = kl * sk.reshape(B, Hkv, W).transpose(1, 2)[..., None]
        vl = vl * sv.reshape(B, Hkv, W).transpose(1, 2)[..., None]
        kl = torch.cat([kl, kb.float()], 1).to(torch.bfloat16)
        vl = torch.cat([vl, vb.float()], 1).to(torch.bfloat16)
        kw.append(kl.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1))
        vw.append(vl.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1))
    amask = torch.cat([torch.ones((S, W), dtype=torch.bool, device="cuda"),
                       torch.ones((S, S), dtype=torch.bool,
                                  device="cuda").tril()], 1)
    q4 = q.permute(0, 2, 1, 3)
    sdpa = lambda i: F.scaled_dot_product_attention(q4, kw[i % L], vw[i % L],
                                                    attn_mask=amask)
    lib = time_ms(sdpa, 96 if S <= 64 else 32, warmup=L)
    lib_dev = graph_ms(sdpa, n=2 * L)
    del kw, vw
    nbytes = (2 * B * W * Hkv * D + 2 * B * W * Hkv * 4 + 2 * q.numel() * 2
              + 2 * kb.numel() * 2 + 4 * B * (1 + pages))
    flops = 4.0 * B * Hq * D * (S * W + S * (S + 1) / 2)
    b_ms, kind = bound_ms(nbytes, flops)
    print(f"  kernel B verify int8 B={B} S={S} W={W} (8B geometry), per "
          f"layer: {ms * 1e3:.1f} us as timed, {dev * 1e3:.1f} us on the "
          f"device (bound {b_ms * 1e3:.1f} us, {kind}; {b_ms / dev:.0%} of "
          f"bound); plain {plain * 1e3:.1f} us; SDPA on a pre-gathered "
          f"window + block, explicit mask (gather excluded) "
          f"{lib * 1e3:.1f} us as timed, {lib_dev * 1e3:.1f} us on the "
          f"device; 32 layers under torch.profiler: split kernel "
          f"{parts['split_device_ms']:.3f} ms, combine past its end "
          f"{parts['combine_device_ms']:.3f} ms", flush=True)
    return dict(ms=round(32 * ms, 4), device_ms=round(32 * dev, 4),
                plain_ms=round(32 * plain, 4), bound_ms=round(32 * b_ms, 4),
                bound_by=kind, library_ms=round(32 * lib, 4),
                library_device_ms=round(32 * lib_dev, 4), **parts)


def phase_kernel_b_verify(results: dict) -> None:
    """Kernel B's verify mode (speculative verify: S candidate positions
    per row over the pool window plus their own k/v under a chain or tree
    mask; the reference's XLA ``paged_attention_verify_append``; a
    session wake's suffix forward, S up to 256; a drafter's catch-up
    feed, S up to 512) against its plain version: int8 and bf16 pools,
    chain and tree masks (random per-row ancestry), S 2, 5, 8, 16 and 64
    (the largest speculative block, wider than D = 32), then the wake's
    S = 128 and 256 under the chain mask at R = 1 and 2 and windows of 128
    and 2048 (one on a tp = 2 rank's heads, Hq 16 over Hkv 4), and
    S = 512 chains at W = 2048 on both pools, rep 1-8,
    D 32-128, page sizes 16, 48 and 64, windows up to 4096, NaN in every
    dead slot; each case also bitwise against a rerun, its rows' B = 1
    calls and a window twice as wide. Timed per 32-layer llama3.1-8b verify at
    B = 8, S = 8, W = 1024 and per 32-layer wake at R = 1, S = 256,
    W = 2048, both on an int8 pool (events and CUDA graph, and the split
    kernel against the merge under torch.profiler) beside the bound and
    SDPA over a pre-gathered, dequantized window plus the block under an
    explicit mask."""
    from p2p_llm_chat_tpu_torch.ops import _build
    from p2p_llm_chat_tpu_torch.ops import paged_attention as pa
    lib = _build.load("paged_attention", pa._bind)
    check(lib.paged_verify_max_s() == 512, "kernel B verify: the widest "
          f"block is {lib.paged_verify_max_s()}, not the drafter's 512")
    print("  kernel B verify kernel, window slice tokens at S = 1, 64, 65, "
          "512: " + ", ".join(str(lib.paged_verify_slice_tokens(S))
                             for S in (1, 64, 65, 512))
          + "; dynamic shared memory per block: "
          + ", ".join(f"{'int8' if qz else 'bf16'} D={D} "
                      f"{lib.paged_verify_smem(qz, D)} B"
                      for qz in (1, 0) for D in (32, 64, 128)))
    worst = 0.0
    cases = (  # (int8, Hq, Hkv, D, ps, W, S, tree, lengths)
        (True, 32, 8, 128, 64, 1024, 8, False, [1024, 1000, 64, 1]),
        (True, 32, 8, 128, 64, 1024, 8, True, [1024, 517, 300, 1]),
        (False, 32, 8, 128, 64, 1024, 5, False, [1024, 1000, 64, 1]),
        (False, 64, 8, 128, 64, 4096, 16, True, [4096, 2100, 513, 1]),
        (True, 64, 8, 128, 16, 1000, 16, False, [1000, 300, 17, 1]),
        (True, 4, 4, 64, 48, 1000, 2, True, [1000, 300, 17, 1]),
        (False, 12, 4, 32, 48, 300, 5, False, [1, 128, 257, 64]),
        (True, 8, 8, 32, 16, 64, 16, True, [64, 40, 17, 1]),
        (False, 56, 8, 64, 64, 4096, 8, True, [4096, 4000, 33, 2]),
        (True, 4, 2, 32, 64, 1024, 64, True, [1024, 700, 65, 1]),
        # Session wakes (llama3.1-8b geometry): a suffix bucket of S
        # positions over the session's pool KV, chain mask.
        (True, 32, 8, 128, 64, 128, 128, False, [128]),
        (False, 32, 8, 128, 64, 128, 256, False, [100]),
        (True, 32, 8, 128, 64, 2048, 256, False, [1532, 64]),
        (False, 32, 8, 128, 64, 2048, 256, False, [2048, 1000]),
        (True, 32, 8, 128, 64, 2048, 128, False, [2048]),
        (False, 32, 8, 128, 64, 128, 128, False, [1, 127]),
        # A wake on one rank of SERVE_TP = 2 (llama3.1-8b's heads cut in
        # two: 16 query heads over 4 kv heads).
        (True, 16, 4, 128, 64, 2048, 256, False, [1532, 64]),
        # The widest block (a drafter's 512-position catch-up feed).
        (True, 32, 8, 128, 64, 2048, 512, False, [2048, 700]),
        (False, 32, 8, 128, 48, 2048, 512, False, [1500, 1]),
    )
    for i, (qz, Hq, Hkv, D, ps, W, S, tree, lengths) in enumerate(cases):
        cache, _, _, _, pages = _paged_case(qz, Hq, Hkv, D, W, lengths,
                                            ps=ps, seed=40 + i)
        _poison_dead(cache, lengths)
        q, kb, vb, mask = _verify_inputs(len(lengths), S, Hq, Hkv, D, 60 + i,
                                         tree)
        worst = max(worst, _v_case(
            f"kernel B verify {'int8' if qz else 'bf16'} Hq={Hq} Hkv={Hkv} "
            f"D={D} ps={ps} W={pages * ps} S={S} "
            f"{'tree' if tree else 'chain'} lengths={lengths}", cache, q,
            kb, vb, mask, pages))
        del cache
    # One llama3.1-8b verify at B = 8, S = 8, W = 1024 (a spec tick of the
    # tree default), and one wake at R = 1, S = 256, W = 2048.
    spec = _v_timing(8, 8, 1024, 97)
    wake = _v_timing(1, 256, 2048, 99)
    results["paged_attention_verify_append"] = dict(
        name="paged_attention_verify_append", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/paged_attention.cu",
        replaces="p2p_llm_chat_tpu/ops/paged_attention.py:635",
        max_abs_err=worst, **spec, wake=wake,
        scope="kernel B verify mode (an XLA function in the reference, no "
              "pl.pallas_call), one llama3.1-8b spec verify at B=8, S=8, "
              "W=1024, int8 pool: 32 launches; device_ms replays them from "
              "a CUDA graph; library_ms is SDPA over an already-gathered "
              "dequantized window plus the block, explicit boolean mask, "
              "excluding the gather; wake: the same at R=1, S=256, W=2048 "
              "(a session wake's forward)")


def _dense_case(Hq, Hkv, D, T, lengths, L=2, seed=0):
    """A dense cache of max_seq T ([L, B, T rounded up to a page, Hkv, D],
    as KVCache.create allocates it) of bf16 normals with NaN in every slot
    at or past each row's length (never attended), and bf16 q."""
    import torch
    from p2p_llm_chat_tpu_torch.models.llama import KVCache
    from p2p_llm_chat_tpu_torch.ops.dense_attention import cache_slots
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    shape = (L, B, cache_slots(T), Hkv, D)
    k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    for b, n in enumerate(lengths):
        k[:, b, n:] = float("nan")
        v[:, b, n:] = float("nan")
    cache = KVCache(k, v, torch.tensor(lengths, dtype=torch.int32,
                                       device=dev), T)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    return cache, q


def _dense_call(cache, q, lengths, W, layer=1, blk=None):
    """A8 through its wrapper: decode mode, or verify mode with ``blk`` =
    (k_blk, v_blk, block_mask or None) and q [B, S, Hq, D]."""
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    if blk is None:
        return da.dense_attention(q, cache, lengths, layer, window=W)
    kb, vb, mask = blk
    return da.dense_attention_verify(q, kb, vb, cache, lengths, layer,
                                     window=W, block_mask=mask)


def _dense_plain(cache, q, lengths, W, layer=1, blk=None):
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    if blk is None:
        return da.dense_attention_plain(q, cache.k, cache.v, lengths, layer,
                                        window=W)
    kb, vb, mask = blk
    return da.dense_attention_verify_plain(q, kb, vb, cache.k, cache.v,
                                           lengths, layer, window=W,
                                           block_mask=mask)


def _dense_case_checks(label, cache, q, lengths, W, blk=None) -> float:
    """One A8 case: within B_TOL of the plain version, a rerun bitwise
    equal, each row bitwise equal to its own B = 1 call (a one-row cache)
    and to the call over the whole cache as the window, and the pool view
    zero-copy. Returns the absolute error."""
    import torch
    from p2p_llm_chat_tpu_torch.models.llama import KVCache
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    kp, vp, table, ps = da.pool_view(cache.k, cache.v)
    check(kp.data_ptr() == cache.k.data_ptr()
          and vp.data_ptr() == cache.v.data_ptr()
          and cache.k.shape[2] % ps == 0 and ps == da.VIEW_PAGE,
          f"{label}: the pool view is not the cache's storage")
    out = _dense_call(cache, q, lengths, W, blk=blk)
    err = _rel_err(label, out, _dense_plain(cache, q, lengths, W, blk=blk),
                   B_TOL)
    check(torch.equal(_dense_call(cache, q, lengths, W, blk=blk), out),
          f"{label}: a rerun differs from the first run")
    T = cache.max_seq
    check(torch.equal(_dense_call(cache, q, lengths, T, blk=blk), out),
          f"{label}: rows differ at the window {T}")
    for b in range(q.shape[0]):
        one = KVCache(cache.k[:, b:b + 1].contiguous(),
                      cache.v[:, b:b + 1].contiguous(), cache.lengths[b:b + 1],
                      T)
        row = lambda t: None if t is None else t[b:b + 1].contiguous()
        rb = None if blk is None else tuple(row(t) for t in blk)
        check(torch.equal(_dense_call(one, row(q), row(lengths), W, blk=rb),
                          out[b:b + 1]),
              f"{label}: row {b} differs between B = 1 and B = "
              f"{q.shape[0]}")
    return err


def _dense_timing(B: int, W: int, L: int = 8, S: int = 0) -> dict:
    """One 32-layer llama3.1-8b step of A8 (decode mode, or verify mode
    at S chain positions) at B rows over a full window of W on a bf16
    dense cache of max_seq 4096 (L layers rotated so the reads stay cold
    in L2): CUDA events back to back (``ms``) and device time replayed
    from a CUDA graph (``device_ms``), beside the plain version, SDPA over
    the window (heads expanded beforehand, not timed; verify: window plus
    block under an explicit mask) and the bound (bytes: the window's k/v,
    q, the block and out once; operations: q.k and p.v)."""
    import torch
    import torch.nn.functional as F
    Hq, Hkv, D, T = 32, 8, 128, 4096
    n = W - S if S else W
    cache, q = _dense_case(Hq, Hkv, D, T, [n] * B, L=L, seed=W + S)
    lengths = cache.lengths if S else cache.lengths
    blk = None
    if S:
        q, kb, vb, _ = _verify_inputs(B, S, Hq, Hkv, D, W + 1, False)
        blk = (kb, vb, None)
    call = lambda i: _dense_call(cache, q, lengths, W, i % L, blk)
    ms = time_ms(call, 96, warmup=L)
    dev = graph_ms(call, n=2 * L)
    parts = _verify_breakdown(call, L) if S else {}
    plain = time_ms(lambda i: _dense_plain(cache, q, lengths, W, i % L, blk),
                    8, warmup=1)
    rep = Hq // Hkv
    kw = [cache.k[l, :, :n].permute(0, 2, 1, 3).repeat_interleave(rep, 1)
          for l in range(L)]
    vw = [cache.v[l, :, :n].permute(0, 2, 1, 3).repeat_interleave(rep, 1)
          for l in range(L)]
    if S:
        kbp = kb.permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        vbp = vb.permute(0, 2, 1, 3).repeat_interleave(rep, 1)
        kw = [torch.cat([x, kbp], 2) for x in kw]
        vw = [torch.cat([x, vbp], 2) for x in vw]
        amask = torch.cat([torch.ones((S, n), dtype=torch.bool,
                                      device="cuda"),
                           torch.ones((S, S), dtype=torch.bool,
                                      device="cuda").tril()], 1)
        q4 = q.permute(0, 2, 1, 3)
        sdpa = lambda i: F.scaled_dot_product_attention(
            q4, kw[i % L], vw[i % L], attn_mask=amask)
    else:
        q4 = q[:, :, None, :]
        sdpa = lambda i: F.scaled_dot_product_attention(q4, kw[i % L],
                                                        vw[i % L])
    lib = time_ms(sdpa, 96, warmup=L)
    lib_dev = graph_ms(sdpa, n=2 * L)
    del kw, vw
    rows = B * max(S, 1)
    nbytes = (2 * B * n * Hkv * D * 2 + 2 * rows * Hq * D * 2 + 4 * B
              + (2 * B * S * Hkv * D * 2 if S else 0))
    flops = 4.0 * B * Hq * D * (max(S, 1) * n + S * (S + 1) / 2)
    b_ms, kind = bound_ms(nbytes, flops)
    mode = f"verify S={S}" if S else "decode"
    print(f"  A8 {mode} bf16 dense B={B} W={W} (8B geometry), per layer: "
          f"{ms * 1e3:.1f} us as timed, {dev * 1e3:.1f} us on the device "
          f"(bound {b_ms * 1e3:.1f} us, {kind}; {b_ms / dev:.0%} of bound; "
          f"host gap {(ms - dev) * 1e3:.1f} us); plain {plain * 1e3:.1f} us; "
          f"SDPA over the window {lib * 1e3:.1f} us as timed, "
          f"{lib_dev * 1e3:.1f} us on the device"
          + (f"; 32 layers under torch.profiler: split kernel "
             f"{parts['split_device_ms']:.3f} ms, combine past its end "
             f"{parts['combine_device_ms']:.3f} ms" if parts else ""),
          flush=True)
    return dict(ms=round(32 * ms, 4), device_ms=round(32 * dev, 4),
                plain_ms=round(32 * plain, 4), bound_ms=round(32 * b_ms, 4),
                bound_by=kind, library_ms=round(32 * lib, 4),
                library_device_ms=round(32 * lib_dev, 4), **parts)


def _wake_call(cache, rows, starts, q, kb, vb, pages, layer=1):
    """The dense wake's attention as the scheduler runs it: kernel B's
    verify mode (``paged_attention_verify_append``, chain mask) over the
    waking ``rows`` of the cache's identity view at committed lengths
    ``starts`` (ops/dense_attention.rows_view)."""
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    from p2p_llm_chat_tpu_torch.ops.paged_attention import \
        paged_attention_verify_append
    view = da.rows_view(cache, rows, starts)
    return paged_attention_verify_append(q, kb, vb, view, view.lengths,
                                         layer, pages=pages)


def _wake_case(label, cache, rows, starts, S, W, seed) -> float:
    """One dense wake case: R = len(rows) suffix blocks of S positions at
    ``starts`` over a window W (pages covering W + S, as the scheduler
    asks), within B_TOL of the plain version (the reference's
    ``attend_gqa`` over ``cache.k/v[l, rows, :W]`` under the chain mask:
    ``dense_attention_verify_plain`` on those rows), a rerun bitwise, each
    row bitwise equal to its own R = 1 call and to the call over the
    whole cache's pages. Returns the absolute error."""
    import torch
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    Hq, Hkv, D = 32, cache.k.shape[3], cache.k.shape[4]
    R = len(rows)
    q, kb, vb, _ = _verify_inputs(R, S, Hq, Hkv, D, seed, False)
    idx = torch.tensor(rows, dtype=torch.long, device="cuda")
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    P = cache.k.shape[2] // da.VIEW_PAGE
    pages = min(-(-(W + S) // da.VIEW_PAGE), P)
    out = _wake_call(cache, idx, st, q, kb, vb, pages)
    err = _rel_err(label, out, da.dense_attention_verify_plain(
        q, kb, vb, cache.k[:, idx], cache.v[:, idx], st, 1, window=W), B_TOL)
    check(torch.equal(_wake_call(cache, idx, st, q, kb, vb, pages), out),
          f"{label}: a rerun differs from the first run")
    check(torch.equal(_wake_call(cache, idx, st, q, kb, vb, P), out),
          f"{label}: rows differ over the whole cache's {P} pages")
    for i in range(R):
        one = lambda t: t[i:i + 1].contiguous()
        check(torch.equal(_wake_call(cache, one(idx), one(st), one(q),
                                     one(kb), one(vb), pages), out[i:i + 1]),
              f"{label}: row {rows[i]} differs between R = 1 and R = {R}")
    return err


def _wake_timing(S: int = 256, W: int = 2048, L: int = 8) -> dict:
    """One 32-layer llama3.1-8b dense wake's attention at R = 1 (row 5 of
    a bf16 cache of 8 x 4096), S suffix positions over W committed slots
    (A4's wake case on the int8 pool: ``kernel_b_verify``), L layers
    rotated: ms as timed and on the device (CUDA graph), the plain
    version, SDPA over the row's window plus the block under an explicit
    mask (heads expanded beforehand) and the bound (bytes: the window's
    k/v, q, the block and out once; operations: q.k and p.v over the
    window and the chain's lower triangle)."""
    import torch
    import torch.nn.functional as F
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    Hq, Hkv, D, T = 32, 8, 128, 4096
    lengths = [W] * 8
    cache, _ = _dense_case(Hq, Hkv, D, T, lengths, L=L, seed=W + S + 1)
    q, kb, vb, _ = _verify_inputs(1, S, Hq, Hkv, D, W + 2, False)
    idx = torch.tensor([5], dtype=torch.long, device="cuda")
    st = torch.tensor([W], dtype=torch.int32, device="cuda")
    pages = W // da.VIEW_PAGE
    call = lambda i: _wake_call(cache, idx, st, q, kb, vb, pages, i % L)
    ms = time_ms(call, 32, warmup=L)
    dev = graph_ms(call, n=2 * L)
    parts = _verify_breakdown(call, L)
    plain = time_ms(lambda i: da.dense_attention_verify_plain(
        q, kb, vb, cache.k[:, idx], cache.v[:, idx], st, i % L,
        window=W + S), 4, warmup=1)
    rep = Hq // Hkv
    kw = [torch.cat([cache.k[l, 5:6, :W], kb], 1).permute(0, 2, 1, 3)
          .repeat_interleave(rep, 1) for l in range(L)]
    vw = [torch.cat([cache.v[l, 5:6, :W], vb], 1).permute(0, 2, 1, 3)
          .repeat_interleave(rep, 1) for l in range(L)]
    amask = torch.cat([torch.ones((S, W), dtype=torch.bool, device="cuda"),
                       torch.ones((S, S), dtype=torch.bool,
                                  device="cuda").tril()], 1)
    q4 = q.permute(0, 2, 1, 3)
    sdpa = lambda i: F.scaled_dot_product_attention(q4, kw[i % L], vw[i % L],
                                                    attn_mask=amask)
    lib = time_ms(sdpa, 32, warmup=L)
    lib_dev = graph_ms(sdpa, n=2 * L)
    del kw, vw, cache
    nbytes = (2 * W * Hkv * D * 2 + 2 * q.numel() * 2 + 2 * kb.numel() * 2
              + 4 * (1 + pages))
    flops = 4.0 * Hq * D * (S * W + S * (S + 1) / 2)
    b_ms, kind = bound_ms(nbytes, flops)
    print(f"  dense wake (kernel B verify mode on the identity view) R=1 "
          f"S={S} W={W} (8B geometry), per layer: {ms * 1e3:.1f} us as "
          f"timed, {dev * 1e3:.1f} us on the device (bound "
          f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / dev:.0%} of bound); plain "
          f"{plain * 1e3:.1f} us; SDPA over the window + block, explicit "
          f"mask {lib * 1e3:.1f} us as timed, {lib_dev * 1e3:.1f} us on the "
          f"device; 32 layers on the device {32 * dev:.3f} ms (under "
          f"torch.profiler: split kernel {parts['split_device_ms']:.3f} ms, "
          f"combine past its end {parts['combine_device_ms']:.3f} ms)",
          flush=True)
    return dict(ms=round(32 * ms, 4), device_ms=round(32 * dev, 4),
                plain_ms=round(32 * plain, 4), bound_ms=round(32 * b_ms, 4),
                bound_by=kind, library_ms=round(32 * lib, 4),
                library_device_ms=round(32 * lib_dev, 4), **parts)


def _dense_lse() -> dict:
    """A8's decode mode with its log-sum-exp at sp decode's shapes
    (parallel/ring.sp_decode_step: B = 2 rows over a rank's 2048-slot
    sequence shard), at llama3.1-8b's heads and a tp = 2 rank's, one row
    with 0 local slots (a shard past its length; NaN in every slot of
    it): the output bitwise equal to the launch without it, lse within
    LSE_ATOL of the plain version's, the empty row 0 with lse -inf. Both
    launches timed at 32 / 8 heads."""
    import torch
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    W, worst, times = 2048, 0.0, {}
    cases = ((32, 8, [1952, 0]), (32, 8, [2048, 905]), (16, 4, [0, 2048]),
             (16, 4, [1, 1400]))
    for i, (Hq, Hkv, lengths) in enumerate(cases):
        cache, q = _dense_case(Hq, Hkv, 128, W, lengths, seed=120 + i)
        label = f"A8 sp decode shard Hq={Hq} Hkv={Hkv} W={W} " \
                f"lengths={lengths}"
        out, lse = da.dense_attention(q, cache, cache.lengths, 1, window=W,
                                      return_lse=True)
        check(torch.equal(out, da.dense_attention(q, cache, cache.lengths,
                                                  1, window=W)),
              f"{label}: the output differs from the launch without the "
              "log-sum-exp")
        ref_out, ref_lse = da.dense_attention_plain(
            q, cache.k, cache.v, cache.lengths, 1, window=W,
            return_lse=True)
        _rel_err(label, out, ref_out, B_TOL)
        worst = max(worst, _lse_err(label, lse, ref_lse))
        for b, n in enumerate(lengths):
            if n == 0:
                check(bool((out[b] == 0).all())
                      and bool(torch.isneginf(lse[b]).all()),
                      f"{label}: the row of 0 slots is not 0 with lse -inf")
        if Hq == 32 and 0 in lengths:
            ln = cache.lengths
            plain = time_ms(lambda i: da.dense_attention(q, cache, ln, 1,
                                                         window=W), 200)
            with_lse = time_ms(lambda i: da.dense_attention(
                q, cache, ln, 1, window=W, return_lse=True), 200)
            plain2 = time_ms(lambda i: da.dense_attention(q, cache, ln, 1,
                                                          window=W), 200)
            dev = graph_ms(lambda i: da.dense_attention(q, cache, ln, 1,
                                                        window=W), n=32)
            dev_lse = graph_ms(lambda i: da.dense_attention(
                q, cache, ln, 1, window=W, return_lse=True), n=32)
            dev2 = graph_ms(lambda i: da.dense_attention(q, cache, ln, 1,
                                                         window=W), n=32)
            n_kv = sum(lengths)           # the slots this call attends
            b_ms, kind = bound_ms(2 * n_kv * Hkv * 128 * 2
                                  + 2 * 2 * Hq * 128 * 2 + 2 * 4 * Hq,
                                  4.0 * Hq * 128 * n_kv)
            times = dict(ms=round(min(plain, plain2), 5),
                         lse_ms=round(with_lse, 5),
                         device_ms=round(min(dev, dev2), 5),
                         lse_device_ms=round(dev_lse, 5),
                         bound_ms=round(b_ms, 5), bound_by=kind)
            print(f"  A8 sp decode shard B=2 W={W} (8B heads): as timed "
                  f"{min(plain, plain2) * 1e3:.1f} us without the lse "
                  f"({plain * 1e3:.1f}, {plain2 * 1e3:.1f}), "
                  f"{with_lse * 1e3:.1f} us with it "
                  f"({with_lse / min(plain, plain2) - 1:+.1%}); on the "
                  f"device (CUDA graphs) {min(dev, dev2) * 1e3:.2f} us "
                  f"({dev * 1e3:.2f}, {dev2 * 1e3:.2f}), "
                  f"{dev_lse * 1e3:.2f} us with it "
                  f"({dev_lse / min(dev, dev2) - 1:+.1%}); bound "
                  f"{b_ms * 1e3:.2f} us ({kind})", flush=True)
        del cache
    return dict(lse_max_abs_err=worst, per_layer=times,
                scope="sp decode's attention on one rank's shard per "
                      "layer: B=2 over a 2048-slot shard, lengths 1952 and "
                      "0, Hq 32, Hkv 8, D 128; ms as timed without the "
                      "log-sum-exp (the faster of two runs around the lse "
                      "run), lse_ms with it; device_ms / lse_device_ms the "
                      "same replayed from CUDA graphs")


def phase_kernel_dense(results: dict) -> None:
    """A8, the dense KV path's attention (the reference's XLA
    ``attend_gqa`` over ``cache.k/v[l, :, :window]`` in ``decode_step``,
    ``verify_step`` and ``verify_tree``), served by kernel B over a
    zero-copy pool view of the dense cache (ops/dense_attention.py),
    against its plain version: decode mode at rep 1-8, D 64 and 128,
    max_seq 1024, 4096 and 1000 / 1100 (64 divides neither: the cache is
    allocated rounded up to a page), windows below and at max_seq, ragged
    lengths, NaN in every slot past a row's length; verify mode at S = 5
    (chain) and an 8-node tree, and at the resident drafter's catch-up
    feeds (serve/draft_model.py: B = 8 rows of draft-400m's Hq 8 / Hkv 4 /
    D 128, chains of S = 16, 64, 256 and 512 over max_seq 4096 at
    W = 1024, 2048 and 4096, ragged committed lengths, one row's block
    ending at the window). Each case also bitwise against a rerun, its rows' B = 1 calls
    and the whole cache as the window, with the view's storage the
    cache's. Then a session wake's attention over the dense cache (the
    scheduler's ``_wake_forward``: kernel B's verify mode on
    ``rows_view``, the waking rows only; :func:`_wake_case`). Timed per
    32-layer llama3.1-8b step at B = 8, W = 1024 and 4096 (decode) and
    W = 1024, S = 5 (verify), and per wake at R = 1, S = 256, W = 2048,
    beside the bound, the plain version and SDPA over the window."""
    import torch
    worst = {"dense_attention": 0.0, "dense_attention_verify": 0.0}
    dec = (  # (Hq, Hkv, D, max_seq, window, lengths incl. the written slot)
        (8, 8, 64, 1024, 1024, [1024, 1, 513, 64]),
        (32, 8, 128, 4096, 4096, [4096, 2100, 1, 777]),
        (64, 8, 128, 1000, 1000, [1000, 999, 50, 1]),
        (24, 8, 64, 1100, 512, [512, 300, 17, 2]),
        (16, 8, 128, 4096, 256, [256, 129, 128, 3]),
        (40, 8, 128, 1024, 768, [700, 768, 1, 65]),
        # llama3.1-8b's heads on one rank of tp = 2 (serve/multihost.py's
        # rounds: one row, the whole bucketed cache as the window).
        (16, 4, 128, 512, 512, [300]),
        (16, 4, 128, 128, 128, [65, 128, 1]),
    )
    for i, (Hq, Hkv, D, T, W, lengths) in enumerate(dec):
        cache, q = _dense_case(Hq, Hkv, D, T, lengths, seed=70 + i)
        worst["dense_attention"] = max(
            worst["dense_attention"], _dense_case_checks(
                f"A8 decode Hq={Hq} Hkv={Hkv} D={D} max_seq={T} W={W} "
                f"lengths={lengths}", cache, q, cache.lengths, W))
        del cache
    ver = (  # (Hq, Hkv, D, max_seq, window, committed lengths, S, tree)
        (32, 8, 128, 4096, 1024, [1019, 500, 1, 0], 5, False),
        (32, 8, 128, 1000, 1000, [992, 400, 3, 0], 8, True),
        (8, 8, 64, 1100, 512, [504, 17, 256, 9], 5, False),
        (64, 8, 128, 1024, 1024, [1016, 1000, 64, 1], 8, True),
        # The drafter's feeds (ModelDrafter._feed: M = 4..512 at B = 8).
        (8, 4, 128, 4096, 1024, [1008, 700, 1, 0, 333, 64, 999, 512], 16,
         False),
        (8, 4, 128, 4096, 4096, [4032, 2049, 0, 17, 1000, 3000, 63, 1],
         64, False),
        (8, 4, 128, 4096, 1024, [768, 511, 1, 0, 600, 64, 300, 129], 256,
         False),
        (8, 4, 128, 4096, 4096, [3840, 2000, 0, 255, 1, 3000, 1024, 700],
         256, False),
        (8, 4, 128, 4096, 1024, [960, 20, 513, 0, 1, 900, 64, 128], 64,
         False),
        (8, 4, 128, 4096, 4096, [4080, 100, 0, 4000, 2048, 7, 64, 1], 16,
         False),
        (8, 4, 128, 4096, 2048, [1536, 700, 0, 1, 1000, 64, 1200, 511],
         512, False),
    )
    for i, (Hq, Hkv, D, T, W, lengths, S, tree) in enumerate(ver):
        cache, _ = _dense_case(Hq, Hkv, D, T, lengths, seed=80 + i)
        q, kb, vb, mask = _verify_inputs(len(lengths), S, Hq, Hkv, D, 90 + i,
                                         tree)
        worst["dense_attention_verify"] = max(
            worst["dense_attention_verify"], _dense_case_checks(
                f"A8 verify Hq={Hq} Hkv={Hkv} D={D} max_seq={T} W={W} "
                f"S={S} {'tree' if tree else 'chain'} lengths={lengths}",
                cache, q, cache.lengths, W, blk=(kb, vb, mask)))
        del cache
    # A session wake over the dense cache (serve/scheduler.py): rows {5}
    # and {6, 1} of a llama3.1-8b-geometry cache of 8 x 4096, ragged
    # session lengths, NaN past each row's length and in every row not
    # waking (no read may leave the waking rows).
    wake_err = 0.0
    wakes = (  # (rows, starts, S, W)
        ([5], [1900], 64, 2048),
        ([6, 1], [1500, 17], 256, 2048),
        ([5], [3840], 256, 4096),
        ([6, 1], [3000, 2049], 64, 4096),
        ([6, 1], [1792, 0], 256, 2048),
    )
    for i, (rows, starts, S, W) in enumerate(wakes):
        lengths = [0] * 8
        for r, n in zip(rows, starts):
            lengths[r] = n
        cache, _ = _dense_case(32, 8, 128, 4096, lengths, seed=100 + i)
        wake_err = max(wake_err, _wake_case(
            f"A8 dense wake rows={rows} starts={starts} S={S} W={W}", cache,
            rows, starts, S, W, 110 + i))
        del cache
    torch.cuda.empty_cache()
    sp_decode = _dense_lse()
    t1024 = _dense_timing(8, 1024)
    t4096 = _dense_timing(8, 4096)
    tver = _dense_timing(8, 1024, S=5)
    twake = _wake_timing()
    src = "p2p_llm_chat_tpu_torch/csrc/paged_attention.cu"
    results["dense_attention"] = dict(
        name="dense_attention", route="cuda", source=src,
        wrapper="p2p_llm_chat_tpu_torch/ops/dense_attention.py",
        replaces="p2p_llm_chat_tpu/models/layers.py:102",
        max_abs_err=worst["dense_attention"], **t1024, w4096=t4096,
        sp_decode=sp_decode,
        scope="A8 decode mode: kernel B's pool mode over the dense cache's "
              "identity pool view (the reference computes it in XLA, no "
              "pl.pallas_call), one llama3.1-8b decode step at B=8, "
              "W=1024, bf16 cache of max_seq 4096: 32 launches; device_ms "
              "replays them from a CUDA graph; library_ms is SDPA over the "
              "window with the heads expanded beforehand; w4096: the same "
              "at W=4096")
    results["dense_attention_verify"] = dict(
        name="dense_attention_verify", route="cuda", source=src,
        wrapper="p2p_llm_chat_tpu_torch/ops/dense_attention.py",
        replaces="p2p_llm_chat_tpu/models/layers.py:102",
        max_abs_err=worst["dense_attention_verify"], **tver,
        wake=dict(max_abs_err=wake_err, **twake),
        scope="A8 verify mode: kernel B's verify mode over the dense "
              "cache's identity pool view, one llama3.1-8b chain verify "
              "at B=8, S=5, W=1024: 32 launches; library_ms is SDPA over "
              "the window plus the block under an explicit mask; wake: a "
              "session wake's attention (paged_attention_verify_append on "
              "the waking rows of the view) at R=1, S=256, W=2048")


E_EDGES = [          # TMA-route edges: M = 1 and 37, H and O off the tile,
    (1, 2048, 4096),     # a cluster of 16, a box past both extents
    (37, 2048, 4096), (32, 2064, 4096), (32, 2048, 4112), (32, 8192, 256),
    (3, 64, 16)]
E_RAGGED = [(5, 100, 200), (37, 4100, 1000), (33, 2048, 136)]


def _e_hard_rows(H: int = 256, n: int = 64):
    """bf16 rows [n, H] whose amax makes ``amax * (1 / 127)`` differ from
    the IEEE ``amax / 127`` (a reciprocal multiply would be one ulp off),
    and numpy's f32 quotient of each row's amax."""
    import numpy as np
    import torch
    rng = np.random.default_rng(18)
    cand = torch.from_numpy((rng.random(20000) * 10.0 ** rng.integers(
        -3, 4, 20000)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    hard = cand[cand * np.float32(1.0 / 127.0) != cand / np.float32(127.0)]
    check(hard.size >= n, f"only {hard.size} hard amax values")
    hard = hard[:n]
    x = rng.standard_normal((n, H)).astype(np.float32)
    x = np.clip(x * hard[:, None], -hard[:, None], hard[:, None])
    x[:, 3] = hard * np.where(np.arange(n) % 2, -1.0, 1.0)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    check(bool((xb.float().abs().amax(dim=1).numpy() == hard).all()),
          "hard rows: amax not representable in bf16")
    return xb, hard / np.float32(127.0)


def phase_kernel_e(results: dict) -> None:
    """Kernel E (w8a8, int8 tensor cores) and the row quantization kernel
    against their plain versions, bitwise (0 ulp): the one-call function
    (``w8a8_matmul``: ``w8a8_quant_rows`` then kernel E as its
    programmatic dependent) and kernel E alone (``w8a8_quantized``) at the
    reference's five SHAPES and llama3.1-8b's five projections at M = 32,
    the TMA route's edges (E_EDGES) and the ragged route's shapes
    (E_RAGGED), each rerun bitwise, rows of an M = 37 call equal to an
    M = 1 call's; the quantization's scale on hard rows equal to numpy's
    f32 quotient. Then the mm_micro twin runs once over both tables (its
    launches are this entry point's) and its device and as-timed times
    fill the records."""
    import numpy as np
    import torch
    from p2p_llm_chat_tpu_torch.models.quant import quantize
    from p2p_llm_chat_tpu_torch.ops import _build
    from p2p_llm_chat_tpu_torch.ops.quant_mm import _sms
    from p2p_llm_chat_tpu_torch.tools import mm_micro
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    sms = _sms(dev)

    xb, quot = _e_hard_rows()
    xq_k, xs_k = mm_micro.quantize_rows_kernel(xb.to(dev))
    xq_t, xs_t = mm_micro.quantize_rows(xb.to(dev))
    xq_c, xs_c = mm_micro.quantize_rows(xb)
    # The quantization kernel's worst error against the plain version:
    # xq against the CPU's, xs against numpy's quotient.
    quant_err = max(
        float((xq_k.cpu().int() - xq_c.int()).abs().max()),
        float(np.abs(xs_k[:, 0].cpu().numpy().astype(np.float64)
                     - quot.astype(np.float64)).max()))
    check(np.array_equal(xs_k[:, 0].cpu().numpy(), quot)
          and np.array_equal(xs_t[:, 0].cpu().numpy(), quot),
          "hard rows: a row scale differs from numpy's f32 amax / 127")
    check(torch.equal(xq_k.cpu(), xq_c) and torch.equal(xq_t.cpu(), xq_c)
          and torch.equal(xs_k.cpu(), xs_c), "hard rows: the card's xq "
          "differs from the CPU's")
    print(f"  row quantization: {len(quot)} hard rows (amax * (1/127) != "
          "amax / 127): xs of w8a8_quant_rows and of quantize_rows on the "
          "card equal numpy's f32 quotient, xq equal the CPU's")

    mm_micro.w8a8_matmul.launches = 0
    mm_micro.w8a8_matmul.launches_by_route = {"tma": 0, "ragged": 0}
    worst_abs, worst_ulp, n_cases = 0.0, 0, 0
    plain_ms = 0.0
    shapes = [(32, H, O) for H, O in mm_micro.SHAPES + mm_micro.PROJ]
    for M, H, O in shapes + E_EDGES + E_RAGGED:
        qt = quantize((torch.randn((H, O), generator=gen, device=dev)
                       * H ** -0.5).to(torch.bfloat16))
        x = torch.randn((M, H), generator=gen, device=dev).to(torch.bfloat16)
        plan = mm_micro.w8a8_plan(M, H, O, sms)
        want = "ragged" if (M, H, O) in E_RAGGED else "tma"
        check(plan.route == want, f"kernel E M={M} H={H} O={O}: route "
              f"{plan.route}, expected {want}")
        xq, xs = mm_micro.quantize_rows(x)
        outs = {
            "function": (lambda: mm_micro.w8a8_matmul(x, qt.q, qt.s),
                         mm_micro.w8a8_matmul_reference(x, qt.q, qt.s)),
            "kernel": (lambda: mm_micro.w8a8_quantized(xq, xs, qt.q, qt.s),
                       mm_micro._epilogue(xq.double() @ qt.q.double(), qt.s,
                                          xs)),
        }
        for what, (call, ref) in outs.items():
            out = call()
            again = call()
            torch.cuda.synchronize()
            ulp = (out.view(torch.int16).int() - ref.view(torch.int16).int()
                   ).abs()
            n_diff = int((ulp > 0).sum())
            worst_ulp = max(worst_ulp, int(ulp.max()))
            check(bool(torch.isfinite(out).all()), f"kernel E {what} M={M} "
                  f"H={H} O={O}: non-finite output")
            check(n_diff == 0, f"kernel E {what} M={M} H={H} O={O}: {n_diff} "
                  f"of {out.numel()} elements differ from the plain version")
            check(torch.equal(out.view(torch.int16), again.view(torch.int16)),
                  f"kernel E {what} M={M} H={H} O={O}: a rerun differs")
            worst_abs = max(worst_abs, (out.float() - ref.float()).abs().max()
                            .item())
            n_cases += 1
            if what == "function" and M == 37:
                one = mm_micro.w8a8_matmul(x[:1].contiguous(), qt.q, qt.s)
                check(torch.equal(one.view(torch.int16),
                                  out[:1].view(torch.int16)),
                      f"kernel E M={M} H={H} O={O}: row 0 differs from its "
                      "M=1 call")
        print(f"  kernel E M={M} H={H} O={O} [{plan.route}, {plan.splits} "
              f"splits of {plan.per} k tiles, cluster {plan.cluster}, "
              f"{plan.stages} stages]: function and kernel alone bitwise "
              "equal to the plain version, reruns bitwise")
        if (H, O) in mm_micro.SHAPES and M == 32:
            plain_ms += time_ms(lambda i: mm_micro.w8a8_matmul_reference(
                x, qt.q, qt.s), 3, warmup=1)
        del qt
        torch.cuda.empty_cache()
    checked_routes = dict(mm_micro.w8a8_matmul.launches_by_route)
    check(all(v > 0 for v in checked_routes.values()),
          f"kernel E: a route never launched in the checks {checked_routes}")
    print(f"  kernel E checks: {n_cases} cases, max {worst_ulp} bf16 ulp "
          f"from the plain version, launches by route {checked_routes}")

    ptxas = [ln.strip() for ln in _build.build_logs.get("w8a8_mm", "")
             .splitlines() if "registers" in ln or "spill" in ln
             or "Compiling entry function" in ln]
    mm_micro.w8a8_matmul.launches = 0
    mm_micro.w8a8_matmul.launches_by_route = {"tma": 0, "ragged": 0}
    mm_micro.w8a8_matmul.quant_launches = 0
    table = mm_micro.main(["--proj", "all"])
    launches = mm_micro.w8a8_matmul.launches
    by_route = dict(mm_micro.w8a8_matmul.launches_by_route)
    quant_launches = mm_micro.w8a8_matmul.quant_launches
    check(launches > 0 and by_route["tma"] > 0 and quant_launches > 0,
          f"the mm_micro twin never launched kernel E's TMA route or the "
          f"row quantization: {by_route}, {quant_launches}")

    def walk(shapes_, col):
        rows_ = [table[hw][col] for hw in shapes_]
        return {k: sum(r[k] for r in rows_) for k in rows_[0]}
    dev_ref, at_ref = walk(mm_micro.SHAPES, "device"), walk(mm_micro.SHAPES,
                                                           "as_timed")
    dev_ll, at_ll = walk(mm_micro.PROJ, "device"), walk(mm_micro.PROJ,
                                                        "as_timed")
    ops = sum(2.0 * 32 * H * O for H, O in mm_micro.SHAPES)
    # Kernel E's own operands: the int8 weight and rows, both scales, the
    # bf16 output.
    nbytes = sum(H * O + 4 * O + 32 * H + 4 * 32 + 2 * 32 * O
                 for H, O in mm_micro.SHAPES)
    b_ms, kind = bound_ms(nbytes, ops, PEAK_INT8_OPS)
    ll_b_ms, _ = bound_ms(sum(H * O + 4 * O + 32 * H + 4 * 32 + 2 * 32 * O
                              for H, O in mm_micro.PROJ),
                          sum(2.0 * 32 * H * O for H, O in mm_micro.PROJ),
                          PEAK_INT8_OPS)
    e = "w8a8-kernel"
    print(f"  kernel E over the reference's SHAPES at M=32: device "
          f"{dev_ref[e]:.4f} ms, as timed {at_ref[e]:.4f} ms (bound "
          f"{b_ms:.4f} ms, {kind}; {b_ms / dev_ref[e]:.0%} of bound on the "
          f"device); with the row quantization kernel {dev_ref['w8a8']:.4f} "
          f"/ {at_ref['w8a8']:.4f} ms; plain {plain_ms:.4f} ms; "
          f"torch._int_mm + epilogue {dev_ref['int8-lib']:.4f} / "
          f"{at_ref['int8-lib']:.4f} ms; kernel A (w8a16) "
          f"{dev_ref['w8a16']:.4f} ms; bf16 torch.matmul {dev_ref['bf16']:.4f}"
          f" ms. llama3.1-8b projections at M=32: kernel E device "
          f"{dev_ll[e]:.4f} ms (bound {ll_b_ms:.4f} ms, "
          f"{ll_b_ms / dev_ll[e]:.0%}), as timed {at_ll[e]:.4f}; kernel A "
          f"{dev_ll['w8a16']:.4f}, torch._int_mm {dev_ll['int8-lib']:.4f}, "
          f"bf16 torch.matmul {dev_ll['bf16']:.4f} ms (device)")
    faster = [hw for hw in mm_micro.SHAPES + mm_micro.PROJ
              if table[hw]["device"][e] < table[hw]["device"]["int8-lib"]]
    print(f"  kernel E faster than torch._int_mm on the device at "
          f"{len(faster)} of {len(mm_micro.SHAPES + mm_micro.PROJ)} shapes")
    results["w8a8_matmul"] = dict(
        name="w8a8_matmul", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/w8a8_mm.cu",
        replaces="tools/mm_micro.py:53",
        launches=launches,
        launches_by_path={"mm_micro --proj all": launches},
        launches_by_route=by_route, checked_launches_by_route=checked_routes,
        max_abs_err=worst_abs, max_ulp=worst_ulp, bound_by=kind,
        scope="kernel E alone on quantized rows, one walk over the "
              "reference's five mm_micro SHAPES at M=32 (5 launches); ms "
              "as timed (CUDA events around eager calls), device_ms from "
              "two CUDA-graph lengths (the reference's timeit); "
              "function_*: w8a8_matmul, the row quantization kernel + "
              "kernel E in one call; plain_ms is the plain "
              "w8a8_matmul_reference; library_*: torch._int_mm with the "
              "same epilogue; llama_proj_*: llama3.1-8b's five "
              "projections",
        ms=round(at_ref[e], 4), device_ms=round(dev_ref[e], 4),
        plain_ms=round(plain_ms, 4), bound_ms=round(b_ms, 4),
        library_ms=round(at_ref["int8-lib"], 4),
        library_device_ms=round(dev_ref["int8-lib"], 4),
        function_ms=round(at_ref["w8a8"], 4),
        function_device_ms=round(dev_ref["w8a8"], 4),
        kernel_a_ms=round(at_ref["w8a16"], 4),
        kernel_a_device_ms=round(dev_ref["w8a16"], 4),
        llama_proj_ms=round(at_ll[e], 4),
        llama_proj_device_ms=round(dev_ll[e], 4),
        llama_proj_bound_ms=round(ll_b_ms, 4),
        llama_proj_kernel_a_ms=round(at_ll["w8a16"], 4),
        llama_proj_library_ms=round(at_ll["int8-lib"], 4),
        llama_proj_library_device_ms=round(dev_ll["int8-lib"], 4),
        per_shape_device_ms={f"{H}x{O}": round(table[(H, O)]["device"][e], 4)
                             for H, O in mm_micro.SHAPES + mm_micro.PROJ},
        ptxas=ptxas)

    # The row quantization kernel alone over the same walk (M = 32).
    xs_ = [torch.randn((32, H), generator=gen, device=dev).to(torch.bfloat16)
           for H, _ in mm_micro.SHAPES]
    q_dev = sum(mm_micro.device_ms(lambda i, x=x: mm_micro.quantize_rows_kernel(
        x), 8, 32) for x in xs_)
    q_ms = sum(time_ms(lambda i, x=x: mm_micro.quantize_rows_kernel(x), 20)
               for x in xs_)
    q_plain = sum(time_ms(lambda i, x=x: mm_micro.quantize_rows(x), 20)
                  for x in xs_)
    q_plain_dev = sum(mm_micro.device_ms(lambda i, x=x: mm_micro.quantize_rows(
        x), 8, 32) for x in xs_)
    q_bound, q_kind = bound_ms(sum(32 * H * 3 + 4 * 32
                                   for H, _ in mm_micro.SHAPES), 0.0)
    print(f"  w8a8_quant_rows over the SHAPES' rows at M=32: device "
          f"{q_dev:.4f} ms, as timed {q_ms:.4f} ms (bound {q_bound:.4f} ms, "
          f"{q_kind}); plain quantize_rows {q_plain_dev:.4f} / {q_plain:.4f} "
          "ms")
    results["w8a8_quant_rows"] = dict(
        name="w8a8_quant_rows", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/w8a8_mm.cu",
        replaces="tools/mm_micro.py:56",
        launches=quant_launches,
        launches_by_path={"mm_micro --proj all": quant_launches},
        max_abs_err=quant_err, bound_by=q_kind,
        scope="the per-row int8 quantization (an XLA fusion around the "
              "reference's pallas_call, no pl.pallas_call of its own), the "
              "rows of one walk over the reference's SHAPES at M=32 (5 "
              "launches); xq and xs bitwise against the plain "
              "quantize_rows; device_ms from two CUDA-graph lengths",
        ms=round(q_ms, 4), device_ms=round(q_dev, 4),
        plain_ms=round(q_plain, 4), plain_device_ms=round(q_plain_dev, 4),
        bound_ms=round(q_bound, 4), library_ms=None)


def _rand_qkv(gen, R, Sq, Skv, Hq, Hkv, D):
    import torch
    dev = torch.device("cuda")

    def rand(S, H):
        return torch.randn((R, S, H, D), generator=gen, device=dev).to(
            torch.bfloat16)
    return rand(Sq, Hq), rand(Skv, Hkv), rand(Skv, Hkv)


def phase_kernel_d(results: dict) -> None:
    """Kernel D (causal prefill attention with a query offset) against its
    plain version at llama3.1-8b / mixtral-8x7b geometry (Hq 32, Hkv 8,
    D 128): whole prompts, the eight 256-wide chunks of a 2048 prompt over
    a carry that holds NaN past each chunk, a suffix after the co-pilot
    template's prefix, and ragged shapes at other head geometries chosen so
    that every q tile the plan can pick (QW = 1, 2, 4, 8 warps per head)
    runs, each with NaN past the last query position. Chunk and suffix rows
    must equal the whole-prompt rows bit for bit, and a rerun the first
    run. Timing: one 2048-token prompt, whole and as 8 chunks, beside SDPA
    (is_causal whole; per chunk over the carry with a lower-right causal
    mask) and beside the bound of the same causal triangle."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from p2p_llm_chat_tpu_torch.models.layers import repeat_kv
    from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
        prefill_attention, prefill_attention_reference, q_tile_plan)
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    nan = float("nan")
    tiles: set[int] = set()

    def case(label, q, k, v, off, poison=None):
        """Kernel D against the plain version; with ``poison``, the kernel
        sees k/v whose slots from ``poison`` on hold NaN (never read)."""
        nonlocal worst
        R, Sq, Hq, D = q.shape
        qw, smem = q_tile_plan(R, Sq, Hq, k.shape[2], D)
        tiles.add(qw)
        kk, vv = k, v
        if poison is not None:
            kk, vv = k.clone(), v.clone()
            kk[:, poison:] = nan
            vv[:, poison:] = nan
        out = prefill_attention(q, kk, vv, off)
        worst = max(worst, _rel_err(
            f"kernel D {label} [q tile {16 * qw} x {Hq // k.shape[2]} "
            f"heads, {Hq // k.shape[2] * qw} warps, {smem} B shared]", out,
            prefill_attention_reference(q, k, v, off), D_TOL))
        return out

    Hq, Hkv, D = 32, 8, 128
    # Whole prompts: a burst's admission groups, and every batch shape of
    # the embed path (R = 2, 4, 8 or 16 rows at S up to 2048).
    for R, S in ((8, 16), (5, 512), (8, 2048), (16, 256), (16, 2048)):
        case(f"whole R={R} S={S}", *_rand_qkv(gen, R, S, S, Hq, Hkv, D), 0)
    S, C = 2048, 256
    q, k, v = _rand_qkv(gen, 1, S, S, Hq, Hkv, D)
    whole = case(f"whole R=1 S={S}", q, k, v, 0)
    check(torch.equal(prefill_attention(q, k, v, 0), whole),
          "kernel D: a rerun differs from the first run")
    for off in range(0, S, C):           # NaN in the unwritten carry slots
        out = case(f"chunk off={off} C={C} of S={S} (NaN past the chunk)",
                   q[:, off:off + C].contiguous(), k, v, off,
                   poison=off + C)
        check(torch.equal(out, whole[:, off:off + C]),
              f"kernel D chunk off={off}: rows differ from the whole-prompt "
              "rows")
    print(f"  kernel D: the {S // C} chunk calls equal the whole-prompt rows "
          "bit for bit; a rerun equals the first run")
    # The co-pilot template's registered prefix (BOS + bytes, minus one).
    P = len(SUGGEST_PREFIX.encode())
    q, k, v = _rand_qkv(gen, 4, P + 128, P + 128, Hq, Hkv, D)
    whole = prefill_attention(q, k, v, 0)
    out = case(f"prefix suffix R=4 P={P} suffix 128", q[:, P:].contiguous(),
               k, v, P)
    check(torch.equal(out, whole[:, P:]), "kernel D prefix suffix: rows "
          "differ from the whole-prompt rows")
    # Ragged: odd offsets and lengths, other head groups (rep 1, 2, 3, 8),
    # D 64 and 32, kv slots past the last query position holding NaN; the
    # larger ones fill 132 SMs with 2-8 warps per head.
    for (R, Sq, off, Hq_, Hkv_, D_) in ((3, 77, 33, 12, 4, 64),
                                        (2, 50, 0, 4, 4, 32),
                                        (2, 40, 7, 64, 8, 128),
                                        (1, 130, 301, 8, 4, 64),
                                        (2, 1100, 13, 8, 8, 32),
                                        (2, 540, 9, 8, 8, 128),
                                        (1, 600, 3, 8, 8, 32),
                                        (2, 540, 5, 16, 8, 64),
                                        (2, 601, 31, 12, 4, 64)):
        q, k, v = _rand_qkv(gen, R, Sq, off + Sq + 19, Hq_, Hkv_, D_)
        case(f"ragged R={R} Sq={Sq} offset={off} Hq={Hq_} Hkv={Hkv_} "
             f"D={D_}", q, k, v, off, poison=off + Sq)
    # llama3.1-8b's heads on one rank of tp = 2 (Hq 16, Hkv 4): a
    # multihost round's prefill (one row, the bucketed prompt) and an
    # embed group.
    for (R, Sq, off) in ((1, 64, 0), (1, 512, 0), (2, 100, 0), (1, 77, 51)):
        q, k, v = _rand_qkv(gen, R, Sq, off + Sq + 13, 16, 4, 128)
        case(f"tp=2 rank R={R} Sq={Sq} offset={off} Hq=16 Hkv=4 D=128", q,
             k, v, off, poison=off + Sq)
    check(tiles >= {1, 2, 4, 8}, f"kernel D: the cases ran q tiles of "
          f"{sorted(tiles)} warps per head only, not 1, 2, 4 and 8")
    ring = _kernel_d_lse(gen)
    # Timing: one llama3.1-8b layer's prefill attention at S = 2048.
    R, S = 1, 2048
    q, k, v = _rand_qkv(gen, R, S, S, Hq, Hkv, D)
    ms = time_ms(lambda i: prefill_attention(q, k, v, 0), 50)
    qcs = [q[:, o:o + C].contiguous() for o in range(0, S, C)]
    chunk_ms = time_ms(lambda i: [prefill_attention(qc, k, v, j * C)
                                  for j, qc in enumerate(qcs)], 20)
    plain = time_ms(lambda i: prefill_attention_reference(q, k, v, 0), 3,
                    warmup=1)
    qs = q.transpose(1, 2)
    ks = repeat_kv(k, Hq // Hkv).transpose(1, 2)
    vs = repeat_kv(v, Hq // Hkv).transpose(1, 2)
    lib = time_ms(lambda i: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), 50)
    # The chunked form's yardstick: one SDPA call per chunk over the carry
    # up to the chunk's end, the causal mask aligned to the lower right.
    lib_chunks = [(qs[:, :, o:o + C], ks[:, :, :o + C], vs[:, :, :o + C],
                   causal_lower_right(C, o + C)) for o in range(0, S, C)]
    chunk_lib = time_ms(lambda i: [F.scaled_dot_product_attention(
        a, b, c, attn_mask=m) for a, b, c, m in lib_chunks], 20)
    flops = 4.0 * R * Hq * D * S * (S + 1) / 2
    b_ms, kind = bound_ms(2 * (2 * R * S * Hq * D + 2 * R * S * Hkv * D),
                          flops)
    # The same causal triangle as chunks: each reads its q rows and the
    # carry up to its end, and writes its rows.
    c_flops = sum(4.0 * R * Hq * D * (C * o + C * (C + 1) / 2)
                  for o in range(0, S, C))
    c_bytes = sum(2 * (2 * R * C * Hq * D + 2 * R * (o + C) * Hkv * D)
                  for o in range(0, S, C))
    cb_ms, c_kind = bound_ms(c_bytes, c_flops)
    print(f"  kernel D whole prompt R={R} S={S} (8B geometry): {ms * 1e3:.1f} "
          f"us per layer (bound {b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} "
          f"of bound; {flops / ms / 1e9:.1f} TFLOP/s); plain "
          f"{plain * 1e3:.1f} us; SDPA (is_causal, repeat_kv'd heads) "
          f"{lib * 1e3:.1f} us")
    print(f"  kernel D as {S // C} chunks of {C}: {chunk_ms * 1e3:.1f} us per "
          f"layer (bound {cb_ms * 1e3:.1f} us, {c_kind}; {cb_ms / chunk_ms:.0%}"
          f" of bound; {c_flops / chunk_ms / 1e9:.1f} TFLOP/s); SDPA per "
          f"chunk (causal_lower_right over the carry) {chunk_lib * 1e3:.1f} "
          "us")
    results["prefill_attention"] = dict(
        name="prefill_attention", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/prefill_attention.cu",
        replaces="p2p_llm_chat_tpu/models/layers.py:226",
        max_abs_err=worst, bound_by=kind,
        scope="one 32-layer llama3.1-8b prefill of a 2048-token prompt "
              "(R=1): 32 launches; chunked_* is the same prompt as 8 "
              "chunks of 256 (256 launches); library_ms is SDPA "
              "(is_causal) over repeat_kv'd heads, chunked_library_ms one "
              "SDPA call per chunk with causal_lower_right",
        ms=round(32 * ms, 4), plain_ms=round(32 * plain, 4),
        bound_ms=round(32 * b_ms, 4), library_ms=round(32 * lib, 4),
        chunked_ms=round(32 * chunk_ms, 4),
        chunked_bound_ms=round(32 * cb_ms, 4),
        chunked_library_ms=round(32 * chunk_lib, 4), ring_hop=ring)


def _lse_err(label: str, lse, ref) -> float:
    """max|lse - ref| over the rows where ref is finite, against
    LSE_ATOL; the rows where ref is -inf must be -inf too."""
    import torch
    torch.cuda.synchronize()
    dead = torch.isneginf(ref)
    check(bool(torch.equal(torch.isneginf(lse), dead)),
          f"{label}: -inf rows differ from the plain version's")
    check(bool(torch.isfinite(lse[~dead]).all()), f"{label}: non-finite "
          "log-sum-exp on a row with something to attend")
    err = (lse[~dead] - ref[~dead]).abs().max().item() if (~dead).any() \
        else 0.0
    print(f"  {label}: lse max_abs_err {err:.3e} (tol {LSE_ATOL:.0e}; "
          f"{int(dead.sum())} rows -inf)")
    check(err <= LSE_ATOL, f"{label}: lse err {err:.3e} > {LSE_ATOL}")
    return err


def _kernel_d_lse(gen) -> dict:
    """Kernel D with its log-sum-exp at a ring hop's shapes
    (parallel/ring.py: a 2048-token chunk of the sp = 2 leg's prompt, R =
    2, against its own chunk at offset 0 and an earlier one at 2048), at
    llama3.1-8b's heads and a tp = 2 rank's: the output bitwise equal to
    the launch without it, lse within LSE_ATOL of the plain version's.
    Both launches timed at 32 / 8 heads, offset 0 and 2048."""
    import torch
    from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
        prefill_attention, prefill_attention_reference)
    R, S, D = 2, 2048, 128
    worst, times = 0.0, {}
    for Hq, Hkv in ((32, 8), (16, 4)):
        for off in (0, S):
            q, k, v = _rand_qkv(gen, R, S, S, Hq, Hkv, D)
            label = f"kernel D ring hop R={R} S={S} offset={off} Hq={Hq} " \
                    f"Hkv={Hkv}"
            out, lse = prefill_attention(q, k, v, off, return_lse=True)
            check(lse.shape == (R, Hq, S) and lse.dtype == torch.float32,
                  f"{label}: lse {tuple(lse.shape)} {lse.dtype}")
            check(torch.equal(out, prefill_attention(q, k, v, off)),
                  f"{label}: the output differs from the launch without "
                  "the log-sum-exp")
            ref_out, ref_lse = prefill_attention_reference(q, k, v, off,
                                                           True)
            _rel_err(label, out, ref_out, D_TOL)
            worst = max(worst, _lse_err(label, lse, ref_lse))
            del ref_out, ref_lse
            if Hq == 32:
                plain = time_ms(lambda i: prefill_attention(q, k, v, off),
                                40)
                with_lse = time_ms(lambda i: prefill_attention(
                    q, k, v, off, return_lse=True), 40)
                plain2 = time_ms(lambda i: prefill_attention(q, k, v, off),
                                 40)
                dev = graph_ms(lambda i: prefill_attention(q, k, v, off),
                               n=8)
                dev_lse = graph_ms(lambda i: prefill_attention(
                    q, k, v, off, return_lse=True), n=8)
                # Row i sees min(off + i + 1, S) keys.
                flops = 4.0 * R * Hq * D * sum(min(off + i + 1, S)
                                               for i in range(S))
                b_ms, kind = bound_ms(
                    2 * (2 * R * S * Hq * D + 2 * R * S * Hkv * D)
                    + 4 * R * Hq * S, flops)
                times[f"offset{off}"] = dict(
                    ms=round(min(plain, plain2), 5),
                    lse_ms=round(with_lse, 5), device_ms=round(dev, 5),
                    lse_device_ms=round(dev_lse, 5), bound_ms=round(b_ms, 5),
                    bound_by=kind)
                print(f"  kernel D ring hop offset={off} (R={R}, S={S}, 8B "
                      f"heads): {min(plain, plain2) * 1e3:.1f} us without "
                      f"the lse ({plain * 1e3:.1f}, {plain2 * 1e3:.1f}), "
                      f"{with_lse * 1e3:.1f} us with it "
                      f"({with_lse / min(plain, plain2) - 1:+.1%}); on the "
                      f"device {dev * 1e3:.1f} / {dev_lse * 1e3:.1f} us "
                      f"({dev_lse / dev - 1:+.1%}); bound {b_ms * 1e3:.1f} us "
                      f"({kind})", flush=True)
    return dict(lse_max_abs_err=worst, per_layer=times,
                scope="one ring hop's attention per layer: R=2 rows of a "
                      "2048-token chunk over a 2048-token chunk, Hq 32, "
                      "Hkv 8, D 128; ms without the log-sum-exp (the "
                      "faster of two runs around the lse run), lse_ms with "
                      "it")


def _rel_err(label: str, out, ref, tol: float) -> float:
    """max|out - ref| checked against ``tol`` of max|ref|; returns the
    absolute error."""
    import torch
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    print(f"  {label}: max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol "
          f"{tol:.0e} of max|plain| {scale:.3e})")
    check(rel <= tol, f"{label}: rel err {rel:.3e} > {tol}")
    return err


def _rand_pool(gen, L, K, O, mode, NE=None, group=None):
    """A stacked quantized weight [L, (NE,) K, O] of scaled-normal values,
    quantized one [K, O] matrix at a time (as the model's init does), or
    2-D [K, O] with L None."""
    import torch
    from p2p_llm_chat_tpu_torch.models.quant import (QTensor4,
                                                     _quantize_leaf,
                                                     quantize4, stream_bufs)
    dev = torch.device("cuda")

    def one():
        w = (torch.randn((K, O), generator=gen, device=dev) * K ** -0.5).to(
            torch.bfloat16)
        if group is not None:
            return quantize4(w, group=group)
        return _quantize_leaf(w, mode, expert=NE is not None)
    if L is None:
        return one()
    inner = (K, O) if NE is None else (NE, K, O)
    if group is None:
        buf = stream_bufs(L, inner, mode, dev)
    else:                          # a grouping the quantizer would not pick
        buf = QTensor4(torch.empty((L, *inner[:-2], K // 2, O),
                                   dtype=torch.int8, device=dev),
                       torch.empty((L, *inner[:-2], K // group, O),
                                   dtype=torch.float32, device=dev))
    for idx in ([(li,) for li in range(L)] if NE is None else
                [(li, e) for li in range(L) for e in range(NE)]):
        qt = one()
        buf.q[idx] = qt.q
        buf.s[idx] = qt.s
    return buf


C_SHAPES = {    # int4 projections: (K, O, launches per decode step)
    ("mixtral-8x7b", "wqkv"): (4096, 6144, 32),
    ("mixtral-8x7b", "wo"): (4096, 4096, 32),
    ("mixtral-8x7b", "lm_head"): (4096, 32000, 1),
    ("llama3.1-8b", "wgu"): (4096, 28672, 32),
    ("llama3.1-8b", "w_down"): (14336, 4096, 32),
    ("llama3.1-8b", "lm_head"): (4096, 128256, 1),
}


def _c_route(M: int, K: int, ng: int) -> str:
    """The route and row tile kernel C takes for M rows of a (K, ng)
    weight, as csrc/quant_mm4.cu's qmm4_plan reports them."""
    from p2p_llm_chat_tpu_torch.ops.quant_mm import kernel_c_plan
    seg, bm = kernel_c_plan(M, K, ng)
    return f"{'mma' if seg else 'fma'} BM={bm}"


def phase_kernel_c(results: dict) -> None:
    """Kernel C (w4a16) against its plain version: every served int4
    grouping planned onto the tensor cores; every byte value exact through
    the 16-, 64- and 128-row tiles; ragged shapes at a layer offset at
    every row count around the tiles, on both routes (the tensor-core
    kernel where 64 divides the group and K/2, else the CUDA-core kernel),
    masked weight and x loads, group 64, ng = 1 and the odd ng = 45 of
    mixtral-large's w_down; the
    int4 projections of mixtral-8x7b and llama3.1-8b with bitwise reruns
    and rows independent of M; timings at M = 8 (decode) and M = 256 (a
    prefill chunk) with the layers rotated so the weight reads stay cold
    in L2."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import CONFIGS
    from p2p_llm_chat_tpu_torch.models.quant import (QTensor4, _int4_group,
                                                     dequantize4)
    from p2p_llm_chat_tpu_torch.ops.quant_mm import (kernel_c_plan,
                                                     quant_matmul4,
                                                     quant_matmul4_reference,
                                                     unpack4)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    routes: set = set()

    # Every contraction the quantizer packs to int4, at every registered
    # config's widths, takes the tensor-core route.
    for cname, cfg in CONFIGS.items():
        for K in {cfg.hidden_size, cfg.num_heads * cfg.head_dim,
                  cfg.intermediate_size}:
            for expert in (False, True):
                group = _int4_group(K, expert)
                if group is not None:
                    check(kernel_c_plan(1, K, K // group)[0] == 64,
                          f"kernel C: {cname} K={K} group={group} is not "
                          f"planned onto the tensor cores")
    print("  kernel C: every served int4 grouping planned onto the tensor "
          "cores (64-row segments)")

    def check_case(label, x, qt, layer):
        nonlocal worst
        route = _c_route(x.shape[0], x.shape[1], qt.s.shape[-2])
        routes.add(route)
        worst = max(worst, _rel_err(
            f"kernel C {label} [{route}]", quant_matmul4(x, qt.q, qt.s, layer),
            quant_matmul4_reference(x, qt.q, qt.s, layer), C_TOL))

    def rand_x(M, K):
        return torch.randn((M, K), generator=gen, device=dev).to(
            torch.bfloat16)

    # Every byte value in every packed row, unit scales: identity rows give
    # the weight back exactly (rows < 128 the low nibbles, the rest the
    # high ones), through each row tile.
    vals = (torch.arange(128, device=dev)[:, None]
            + torch.arange(256, device=dev)[None, :]) % 256
    q_all = vals.to(torch.uint8).view(torch.int8).contiguous()
    s_one = torch.ones((1, 256), device=dev)
    w_all = unpack4(q_all).float()
    for M in (16, 64, 256):
        eye = torch.eye(256, device=dev)[:M].to(torch.bfloat16).contiguous()
        out = quant_matmul4(eye, q_all, s_one)
        torch.cuda.synchronize()
        check(torch.equal(out.float(), w_all[:M]),
              f"kernel C: nibble -> bf16 not exact at M={M}")
        routes.add(_c_route(M, 256, 1))
    print("  kernel C: all 256 byte values exact, both nibbles, through the "
          "16-, 64- and 128-row tiles")

    # (K, O, group): the tensor-core route at odd ng = 3 with G = 128 (the
    # high half starts mid-group; O % 16 != 0: masked weight loads), at ng
    # = 1 (one tile) and at mixtral-large's w_down, ng = 45; the CUDA-core
    # route at G = 64 with odd ng = 3 (K/2 = 96), G = 48, K = 96 with ng =
    # 1, and G = 50.
    ragged_m = (1, 8, 15, 16, 17, 63, 64, 65, 100, 128, 255, 256, 257, 512)
    for (K, O, group, ms) in ((384, 136, 128, ragged_m),
                              (128, 256, 128, ragged_m),
                              (192, 200, 64, ragged_m),
                              (288, 264, 48, ragged_m),
                              (96, 40, 96, ragged_m),
                              (100, 130, 50, ragged_m),
                              (11520, 4096, 256, (1, 8, 17, 128, 512))):
        qt = _rand_pool(gen, 2, K, O, "int4", group=group)
        for M in ms:
            check_case(f"K={K} O={O} G={group} ng={K // group} M={M} "
                       f"layer=1", rand_x(M, K), qt, 1)
        del qt
    # x not 16-byte aligned: masked x loads on every tile.
    qt = _rand_pool(gen, 2, 128, 256, "int4", group=128)
    flat = torch.randn((1 + 65 * 128,), generator=gen, device=dev).to(
        torch.bfloat16)
    for M in (5, 17, 65):
        x = flat[1:1 + M * 128].view(M, 128)
        check(x.data_ptr() % 16 != 0, "misaligned case is aligned")
        check_case(f"K=128 O=256 M={M} x at +2 bytes", x, qt, 1)
    del qt
    per_ms: dict = {}
    chunk = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for (model, name), (K, O, per_step) in C_SHAPES.items():
        lm = name == "lm_head"
        nl = 1 if lm else max(2, min(8, math.ceil(
            3 * L2_BYTES / (K // 2 * O))))
        qt = _rand_pool(gen, None if lm else nl, K, O, "int4")
        ng = qt.s.shape[-2]
        layer_of = (lambda i: None) if lm else (lambda i, nl=nl: i % nl)
        for M in (1, 8, 17, 32, 100, 512):
            check_case(f"{model} {name} K={K} O={O} ng={ng} M={M}",
                       rand_x(M, K), qt, layer_of(1))
        # Determinism and row independence, as for kernel A.
        x = rand_x(256, K)
        full = quant_matmul4(x, qt.q, qt.s, layer_of(1))
        check(torch.equal(full, quant_matmul4(x, qt.q, qt.s, layer_of(1))),
              f"kernel C {model} {name}: reruns differ")
        for M in (1, 8, 17):
            check(torch.equal(full[:M], quant_matmul4(
                x[:M].contiguous(), qt.q, qt.s, layer_of(1))),
                f"kernel C {model} {name}: rows of the M=256 call differ "
                f"from the M={M} call")
        print(f"  kernel C {model} {name}: reruns bitwise equal; rows of "
              f"M=256 bitwise equal to the M=1, 8, 17 calls")
        wl = ([dequantize4(qt)] if lm else
              [dequantize4(QTensor4(qt.q[i], qt.s[i])) for i in range(nl)])
        wbytes = K // 2 * O + 4 * ng * O
        if not lm:                 # a 256-row prefill chunk
            M = 256
            xc = rand_x(M, K)
            ms = time_ms(lambda i: quant_matmul4(xc, qt.q, qt.s,
                                                 layer_of(i)), 10)
            lib = time_ms(lambda i: torch.matmul(xc, wl[i % nl]), 10)
            b_ms, kind = bound_ms(wbytes + 2 * M * (K + O), 2.0 * M * K * O)
            print(f"  kernel C {model} {name} M=256: {ms * 1e3:.1f} us "
                  f"(bound {b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of "
                  f"bound; {2.0 * M * K * O / ms / 1e9:.1f} TFLOP/s); "
                  f"torch.matmul on a pre-dequantized bf16 weight "
                  f"{lib * 1e3:.1f} us")
            if model == "mixtral-8x7b":
                for k, v in zip(("ms", "bound_ms", "library_ms"),
                                (ms, b_ms, lib)):
                    chunk[k] += per_step * v
        x = rand_x(8, K)
        ms = time_ms(lambda i: quant_matmul4(x, qt.q, qt.s, layer_of(i)), 50)
        dev_ms = graph_ms(lambda i: quant_matmul4(x, qt.q, qt.s,
                                                  layer_of(i)))
        plain = time_ms(lambda i: quant_matmul4_reference(
            x, qt.q, qt.s, layer_of(i)), 3, warmup=1)
        lib = time_ms(lambda i: torch.matmul(x, wl[i % len(wl)]), 50)
        del wl
        b_ms, kind = bound_ms(wbytes + 2 * 8 * (K + O), 2.0 * 8 * K * O)
        print(f"  kernel C {model} {name} M=8: {ms * 1e3:.1f} us (bound "
              f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of bound; "
              f"device {dev_ms * 1e3:.1f} us in a CUDA graph); plain "
              f"{plain * 1e3:.1f} us; torch.matmul on a pre-dequantized "
              f"bf16 weight {lib * 1e3:.1f} us")
        per_ms[(model, name)] = (ms, plain, b_ms, lib, dev_ms, per_step)
        del qt
        torch.cuda.empty_cache()
    per_ms[("llama3.1-8b", "wqkv")] = per_ms[("mixtral-8x7b", "wqkv")]
    per_ms[("llama3.1-8b", "wo")] = per_ms[("mixtral-8x7b", "wo")]
    steps = {}
    for model in ("mixtral-8x7b", "llama3.1-8b"):
        rows = [v for (m, _), v in per_ms.items() if m == model]
        steps[model] = [sum(r[j] * r[5] for r in rows) for j in range(5)]
        print(f"  kernel C per {model} int4 decode step (B=8, "
              f"{sum(r[5] for r in rows)} launches): {steps[model][0]:.3f} "
              f"ms vs bound {steps[model][2]:.3f} ms (device "
              f"{steps[model][4]:.3f} ms in CUDA graphs); plain "
              f"{steps[model][1]:.3f} ms; torch.matmul on pre-dequantized "
              f"bf16 {steps[model][3]:.3f} ms")
    print(f"  kernel C per 256-row mixtral-8x7b int4 chunk (wqkv, wo: 64 "
          f"layer launches): {chunk['ms']:.3f} ms vs bound "
          f"{chunk['bound_ms']:.3f} ms; torch.matmul on pre-dequantized "
          f"bf16 {chunk['library_ms']:.3f} ms")
    print(f"  kernel C routes run: {', '.join(sorted(routes))}")
    for want in ("fma BM=16", "mma BM=16", "mma BM=64", "mma BM=128"):
        check(want in routes,
              f"kernel C: no case ran {want}")
    ms, plain, b_ms, lib, dev_ms = steps["mixtral-8x7b"]
    results["quant_matmul4"] = dict(
        name="quant_matmul4", route="cuda",
        source="p2p_llm_chat_tpu_torch/csrc/quant_mm4.cu",
        replaces="p2p_llm_chat_tpu/ops/quant_mm.py:438",
        also_replaces="p2p_llm_chat_tpu/ops/quant_mm.py:475",
        max_abs_err=worst, bound_by="bytes",
        scope="one mixtral-8x7b int4 decode step at B=8: 32 x (wqkv, wo) + "
              "lm_head = 65 launches; library_ms is torch.matmul on "
              "pre-dequantized bf16 weights; device_ms is the same step's "
              "launches replayed from CUDA graphs (no host cost); "
              "prefill_chunk_* are the 64 layer launches of one 256-row "
              "chunk",
        ms=round(ms, 4), plain_ms=round(plain, 4), bound_ms=round(b_ms, 4),
        library_ms=round(lib, 4), device_ms=round(dev_ms, 4),
        llama_int4_step_ms=round(steps["llama3.1-8b"][0], 4),
        **{f"prefill_chunk_{k}": round(v, 4) for k, v in chunk.items()})


E_SHAPES = {"wgu_e": (4096, 28672), "w_down": (14336, 4096)}  # mixtral-8x7b


def phase_kernel_experts(results: dict) -> None:
    """The expert grids of kernel A (int8) and kernel C (int4) against
    their plain versions at mixtral-8x7b's expert shapes (8 experts), at a
    layer offset of a 2-layer pool, over buckets of C in {1, 8, 17, 32,
    100, 128, 512} rows, with bitwise reruns and bucket rows independent
    of C; timings at the decode bucket C = 8 and at the 128-row buckets of
    a 256-row chunk, with the layers rotated."""
    import torch
    from p2p_llm_chat_tpu_torch.models.quant import dequantize, dequantize4
    from p2p_llm_chat_tpu_torch.ops import quant_mm as qmm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    NE, L = 8, 2
    for mode, name in (("int8", "quant_matmul_experts_stacked"),
                       ("int4", "quant_matmul_experts_stacked4")):
        fn = getattr(qmm, name)
        plain_fn = getattr(qmm, name + "_reference")
        worst = 0.0
        step = [0.0, 0.0, 0.0, 0.0]
        bucket = [0.0, 0.0, 0.0]
        # Row tiles are 16, 64 and 128: buckets that are not a tile
        # multiple (17, 100) and the 128-row bucket a 256-row mixtral
        # chunk gives each expert (top-2 of 8, capacity 2).
        for wname, (K, O) in E_SHAPES.items():
            qt = _rand_pool(gen, L, K, O, mode, NE=NE)
            ng = qt.s.shape[-2]
            deq = dequantize if mode == "int8" else dequantize4
            for C in (1, 8, 17, 32, 100, 128, 512):
                x = torch.randn((NE, C, K), generator=gen, device=dev).to(
                    torch.bfloat16)
                route = "" if mode == "int8" else f" [{_c_route(C, K, ng)}]"
                worst = max(worst, _rel_err(
                    f"{name} {wname} NE={NE} K={K} O={O} ng={ng} C={C} "
                    f"layer=1{route}", fn(x, qt.q, qt.s, 1),
                    plain_fn(x, qt.q, qt.s, 1), C_TOL))
            x = torch.randn((NE, 256, K), generator=gen, device=dev).to(
                torch.bfloat16)
            full = fn(x, qt.q, qt.s, 1)
            check(torch.equal(full, fn(x, qt.q, qt.s, 1)),
                  f"{name} {wname}: reruns differ")
            for C in (1, 8, 17):
                check(torch.equal(full[:, :C], fn(
                    x[:, :C].contiguous(), qt.q, qt.s, 1)),
                    f"{name} {wname}: bucket rows of the C=256 call differ "
                    f"from the C={C} call")
            print(f"  {name} {wname}: reruns bitwise equal; bucket rows of "
                  f"C=256 bitwise equal to the C=1, 8, 17 calls")
            wbytes = qt.q[0].numel() + 4 * qt.s[0].numel()
            wl = [deq(type(qt)(qt.q[i], qt.s[i])) for i in range(L)]
            x = torch.randn((NE, 128, K), generator=gen, device=dev).to(
                torch.bfloat16)
            ms = time_ms(lambda i: fn(x, qt.q, qt.s, i % L), 10)
            lib = time_ms(lambda i: torch.bmm(x, wl[i % L]), 10)
            b_ms, kind = bound_ms(wbytes + 2 * NE * 128 * (K + O),
                                  2.0 * NE * 128 * K * O)
            print(f"  {name} {wname} C=128: {ms * 1e3:.1f} us (bound "
                  f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of "
                  f"bound); torch.bmm on a pre-dequantized bf16 pool "
                  f"{lib * 1e3:.1f} us")
            for j, v in enumerate((ms, b_ms, lib)):
                bucket[j] += 32 * v
            x = torch.randn((NE, 8, K), generator=gen, device=dev).to(
                torch.bfloat16)
            ms = time_ms(lambda i: fn(x, qt.q, qt.s, i % L), 20)
            plain = time_ms(lambda i: plain_fn(x, qt.q, qt.s, i % L), 3,
                            warmup=1)
            lib = time_ms(lambda i: torch.bmm(x, wl[i % L]), 20)
            del wl
            b_ms, kind = bound_ms(wbytes + 2 * NE * 8 * (K + O),
                                  2.0 * NE * 8 * K * O)
            print(f"  {name} {wname} C=8: {ms * 1e3:.1f} us (bound "
                  f"{b_ms * 1e3:.1f} us, {kind}; {b_ms / ms:.0%} of bound); "
                  f"plain {plain * 1e3:.1f} us; torch.bmm on a "
                  f"pre-dequantized bf16 pool {lib * 1e3:.1f} us")
            for j, v in enumerate((ms, plain, b_ms, lib)):
                step[j] += 32 * v
            del qt
            torch.cuda.empty_cache()
        print(f"  {name} per mixtral-8x7b {mode} decode step (B=8, 64 "
              f"launches): {step[0]:.3f} ms vs bound {step[2]:.3f} ms; "
              f"torch.bmm on pre-dequantized bf16 {step[3]:.3f} ms")
        print(f"  {name} per 256-row mixtral-8x7b chunk (buckets of "
              f"C=128, 64 launches): {bucket[0]:.3f} ms vs bound "
              f"{bucket[1]:.3f} ms; torch.bmm on pre-dequantized bf16 "
              f"{bucket[2]:.3f} ms")
        results[name] = dict(
            name=name, route="cuda",
            source=("p2p_llm_chat_tpu_torch/csrc/quant_mm.cu" if mode ==
                    "int8" else "p2p_llm_chat_tpu_torch/csrc/quant_mm4.cu"),
            replaces=("p2p_llm_chat_tpu/ops/quant_mm.py:518" if mode ==
                      "int8" else "p2p_llm_chat_tpu/ops/quant_mm.py:564"),
            max_abs_err=worst, bound_by="bytes",
            scope=f"one mixtral-8x7b {mode} decode step at B=8 (dropless "
                  "buckets of C=8): 32 x (wgu_e, w_down) = 64 launches; "
                  "library_ms is torch.bmm on pre-dequantized bf16 pools; "
                  "prefill_chunk_* are the 64 launches of one 256-row "
                  "chunk (buckets of C=128)",
            ms=round(step[0], 4), plain_ms=round(step[1], 4),
            bound_ms=round(step[2], 4), library_ms=round(step[3], 4),
            **{f"prefill_chunk_{k}": round(v, 4) for k, v in
               zip(("ms", "bound_ms", "library_ms"), bucket)})


# -- phase 3: one full-width decode step, card vs CPU -------------------------

def _chunked_prefill(fam, params, cfg, toks, n: int, C: int):
    """``toks`` [1, S] (``n`` real tokens) prefilled in chunks of ``C``
    through the family's ``prefill_chunk`` over a dense carry, as the
    scheduler's chunked admission does; returns the last-prompt-position
    logits [1, V]."""
    import torch
    S = toks.shape[1]
    k, v = fam.new_carry(cfg, 1, S, torch.bfloat16, toks.device)
    out = None
    for off in range(0, S, C):
        local = torch.tensor([n - 1 - off], device=toks.device)
        lg = fam.prefill_chunk(params, cfg, toks[:, off:off + C], k, v, off,
                               local.clamp(0, C - 1))
        if 0 <= n - 1 - off < C:
            out = lg[:, 0]
    return out


def _persistent(sched) -> dict:
    """The scheduler's persistent decode state by name: what a decode
    program reads and writes in place."""
    c = sched._cache
    out = {"k": c.k, "v": c.v, "lengths": c.lengths, "next": sched._next,
           "keys": sched._keys_dev, "ring": sched._ring_dev,
           "active": sched._active_dev}
    if sched.kv_mode == "paged":
        out["page_table"] = c.page_table
        if c.k_scale is not None:
            out.update(k_scale=c.k_scale, v_scale=c.v_scale)
    return out


def _snapshot(sched, K: int = 0) -> dict:
    snap = {n: t.clone() for n, t in _persistent(sched).items()}
    if K:
        snap["toks"] = sched._toks_out[K].clone()
    return snap


def _restore(sched, snap: dict) -> None:
    for n, t in _persistent(sched).items():
        t.copy_(snap[n])


def _bitwise(label: str, a: dict, b: dict) -> None:
    import torch
    for name in a:
        if name in b:
            check(torch.equal(a[name], b[name]), f"{label}: {name} differs")


def _launch_counts() -> dict:
    return {n: f.launches for n, f in _wrappers().items()}


def _fill_decode_state(sched, lengths, gen) -> None:
    """Random pool contents (int8 values and scales, or bf16 normals),
    rows' tables 1.., ``lengths``, random feed, greedy rows 0-3 and
    sampled rows 4-7 (temperature with top-p, top-k or a repeat penalty),
    keys [100 + b, 0], a ring holding a few ids, every row live."""
    import torch
    c = sched._cache
    B, dev = sched.num_slots, c.k.device
    if getattr(c, "k_scale", None) is not None:
        c.k.random_(-127, 128, generator=gen)
        c.v.random_(-127, 128, generator=gen)
        c.k_scale.uniform_(0.0, 1.0 / 64, generator=gen)
        c.v_scale.uniform_(0.0, 1.0 / 64, generator=gen)
    else:
        c.k.normal_(generator=gen)
        c.v.normal_(generator=gen)
    if sched.kv_mode == "paged":
        mppr = c.max_pages_per_row
        c.page_table.copy_(1 + torch.arange(B * mppr, dtype=torch.int32,
                                            device=dev).reshape(B, mppr))
    c.lengths.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
    V = sched.config.vocab_size
    sched._next.random_(0, V, generator=gen)
    sampled = [0.0] * 4 + [0.8, 0.7, 1.0, 0.6]
    sched._temps_dev.copy_(torch.tensor(sampled[:B]))
    sched._top_ks_dev.copy_(torch.tensor([0, 0, 0, 0, 0, 40, 0, 9][:B]))
    sched._top_ps_dev.copy_(torch.tensor([1.0] * 4 + [0.9, 1.0, 0.95,
                                                      1.0][:B]))
    sched._rps_dev.copy_(torch.tensor([1.0, 1.0, 1.1, 1.0, 1.0, 1.0, 1.2,
                                       1.0][:B]))
    sched._keys_dev.copy_(torch.tensor([[100 + b, 0] for b in range(B)]))
    sched._ring_dev.fill_(V)
    sched._ring_dev[:, :8].random_(0, V, generator=gen)
    sched._active_dev.fill_(True)


def _graph_checks(label: str, cfg, params, impl: str,
                  quantized: bool, kv_mode: str = "paged") -> None:
    """The scheduler's decode programs on the card at full width (B = 8
    rows of the phase's model): the window ladder captured as warmup
    does it (graphs, their capture time and the memory reserved meanwhile
    printed); then from one state (random pool, rows 63-504 tokens long,
    greedy and sampled rows) the K = 1 graph replay bitwise against the
    eager step function (tokens, pool bytes, lengths, feed, keys, ring)
    with the same launch-counter deltas; and the K = 4 graph bitwise
    against four K = 1 replays (the host parking a row at its stop
    token between them) and against eager ``decode_fused``, with greedy
    row 0's EOS landing mid-burst."""
    import torch
    from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    B, w = 8, 512
    sched = BatchScheduler(params, cfg, ByteTokenizer(cfg.vocab_size),
                           num_slots=B, max_seq=1024, page_size=64,
                           kv_quant=quantized, attn_impl=impl,
                           decode_fuse_max=4, kv_mode=kv_mode,
                           device="cuda")
    sched.stop()          # the test drives the programs from this thread
    torch.cuda.synchronize()
    # Unused cached blocks are returned before and after, so what stays
    # reserved is the graphs' shared pool (each capture empties the cache
    # on entry).
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.monotonic()
    for win in sched._window_ladder():
        sched._warm_window(win)
    torch.cuda.synchronize()
    cap_s = time.monotonic() - t0
    torch.cuda.empty_cache()
    pool_mb = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    check(len(sched._programs) == len(sched._window_ladder()) * 3,
          f"step {label}: {len(sched._programs)} programs captured")
    w = min(w, sched.max_seq)
    gen = torch.Generator(device="cuda").manual_seed(9)
    _fill_decode_state(sched, [(w - 8) * (b + 1) // B for b in range(B)],
                       gen)
    s0 = _snapshot(sched)

    c0 = _launch_counts()
    sched._step_fn(w, 1)()
    eager_n = {n: v - c0[n] for n, v in _launch_counts().items()
               if v != c0[n]}
    eager = _snapshot(sched, 1)
    _restore(sched, s0)
    k1 = sched._decode_for(w)
    c0 = _launch_counts()
    k1()
    replay_n = {n: v - c0[n] for n, v in _launch_counts().items()
                if v != c0[n]}
    _bitwise(f"step {label}: K=1 graph replay vs eager step", eager,
             _snapshot(sched, 1))
    check(replay_n == eager_n, f"step {label}: a K=1 replay counts "
          f"{replay_n}, the eager step launched {eager_n}")

    k4 = sched._decode_fused_for(w, 4)
    _restore(sched, s0)
    k4()
    stop = int(sched._toks_out[4][1, 0])     # greedy row 0's 2nd token
    stop_ids = sched._stop_dev.clone()
    sched._stop_dev[0] = stop
    _restore(sched, s0)
    k4()
    fused = _snapshot(sched, 4)
    steps = int(fused["lengths"][0] - s0["lengths"][0])
    check(steps < 4, f"step {label}: row 0's EOS did not land mid-burst")
    _restore(sched, s0)
    toks = []
    for _ in range(4):
        k1()
        t = sched._toks_out[1][0].clone()
        toks.append(t)
        sched._active_dev &= ~torch.isin(t, sched._stop_dev)
    plain = _snapshot(sched)
    plain["toks"] = torch.stack(toks)
    del plain["active"]        # the host parked row 0; the graph did not
    _bitwise(f"step {label}: K=4 graph vs 4 K=1 replays", fused, plain)
    _restore(sched, s0)
    sched._step_fn(w, 4)()
    _bitwise(f"step {label}: K=4 graph vs eager decode_fused", fused,
             _snapshot(sched, 4))
    sched._stop_dev.copy_(stop_ids)
    torch.cuda.synchronize()
    print(f"step: {label}: {len(sched._programs)} decode graphs "
          f"({len(sched._window_ladder())} windows x K 1, 2, 4) captured in "
          f"{cap_s:.1f} s, their pool {pool_mb:.1f} MB; at W={w}, "
          f"B={B} (4 greedy, 4 sampled rows): K=1 replay bitwise equal to "
          f"the eager step, launches per replay {replay_n}; K=4 replay "
          f"bitwise equal to 4 K=1 replays and to eager decode_fused, row "
          f"0 parked after {steps} steps by EOS {stop}; tokens "
          f"{fused['toks'][:, :].tolist()}", flush=True)


def _clone_cache(cache, device=None):
    from p2p_llm_chat_tpu_torch.ops.paged_kv import PagedKVCache
    return PagedKVCache(*(None if t is None else t.clone().to(
        device or t.device) for t in (cache.k, cache.v, cache.page_table,
                                      cache.lengths, cache.k_scale,
                                      cache.v_scale)))


class _Routes:
    """Records, while active, each MoE layer's expert choice per token
    (the sorted top-k of models/mixtral.moe_mlp's router, [B, S, k]) by
    wrapping the module's ``moe_mlp``: a position whose choice differs
    between the card and the CPU (a near-tie of router scores that bf16
    rounding tips) takes another expert's MLP, and its logits are not
    comparable."""

    def __enter__(self):
        from p2p_llm_chat_tpu_torch.models import mixtral
        self.calls, self._orig = [], mixtral.moe_mlp

        def moe(x, router, *args, **kw):
            r = router if kw.get("layer") is None else router[kw["layer"]]
            probs = (x.float() @ r.float()).softmax(-1)
            k = args[3] if len(args) > 3 else kw["num_experts_per_tok"]
            top = mixtral._top_k(probs, k)[1].sort(-1).values
            self.calls.append(top.cpu())
            return self._orig(x, router, *args, **kw)

        mixtral.moe_mlp = moe
        return self

    def __exit__(self, *exc):
        from p2p_llm_chat_tpu_torch.models import mixtral
        mixtral.moe_mlp = self._orig

    def flips(self, other: "_Routes"):
        """[B, S] bool: positions whose expert choice differs in any
        layer."""
        out = None
        for a, b in zip(self.calls, other.calls):
            d = (a != b).any(-1)
            out = d if out is None else out | d
        return out


def _verify_runs(fam, params, cfg, cache, impl: str, S: int = 5,
                 N: int = 8) -> list:
    """The speculative verify forwards on the card from the step phase's
    pool (row 0 live, row 1 parked at length 0): ``verify_step_paged``
    on ``impl``'s branch (S positions), and on the gather branch
    ``verify_tree_paged`` (N nodes of a random tree), each on a copy of
    the pool. Checks each launched its kernel on every layer (kernel B's
    verify mode on the gather branch, its pool mode S times a layer on
    write-then-attend) and nothing else of kernel B. Returns, per run,
    what the CPU replays: (name, call, card logits, card pool after,
    pool before, expert choices, block width, None), on the host (the
    last field is :func:`_wake_run`'s)."""
    import torch
    dev = cache.k.device
    gen = torch.Generator().manual_seed(21)
    B, L = cache.lengths.shape[0], cfg.num_layers
    n = int(cache.lengths.max())
    vt = torch.randint(33, 126, (B, max(S, N)), generator=gen)
    anc = torch.zeros((B, N, N), dtype=torch.bool)
    depths = torch.zeros((B, N), dtype=torch.long)
    for b in range(B):
        for i in range(N):
            anc[b, i, i] = True
            if i:
                par = int(torch.randint(0, i, (1,), generator=gen))
                anc[b, i] |= anc[b, par]
                depths[b, i] = depths[b, par] + 1
    pages = -(-(n + max(S, N)) // cache.page_size)
    runs = [("verify_step_paged", lambda p, c, d: fam.verify_step_paged(
        p, cfg, vt[:, :S].to(d), c, pages=pages, impl=impl)[0])]
    if impl == "gather":
        runs.append(("verify_tree_paged", lambda p, c, d:
                     fam.verify_tree_paged(p, cfg, vt[:, :N].to(d),
                                           depths.to(d), anc.to(d), c,
                                           pages=pages)[0]))
    out = []
    for name, call in runs:
        c = _clone_cache(cache)
        before = _clone_cache(cache, "cpu")
        c0 = _launch_counts()
        with _Routes() as routes:
            logits = call(params, c, dev).float().cpu()
        moved = {k: v - c0[k] for k, v in _launch_counts().items()
                 if v != c0[k]}
        want = ({"paged_attention_verify_append": L} if impl == "gather"
                else {"paged_attention": S * L})
        got = {k: v for k, v in moved.items() if k.startswith("paged")}
        check(got == want, f"{name} impl={impl}: kernel B launches {got}, "
              f"want {want}")
        out.append((name, call, logits, _clone_cache(c, "cpu"), before,
                    routes, logits.shape[1], None))
    return out


def _wake_run(fam, params, cfg, S: int = 256) -> tuple:
    """A session wake's forward on the card (R = 1, S suffix positions,
    ``verify_step_paged(last_idx=...)`` on the gather branch): a 100-token
    session prefilled into an int8 pool whose row table covers the block,
    a suffix of 200 tokens right-padded to S. Checks that it launched
    kernel B's verify mode on every layer and a quantized matmul kernel.
    Returns :func:`_verify_runs`'s tuple, the block width S and the
    logits' position (199) last."""
    import torch
    from p2p_llm_chat_tpu_torch.ops.paged_kv import (PagedKVCache,
                                                     write_prefill_batch)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(23)
    n, ps, suf = 100, 64, 200
    mppr = -(-(n + S) // ps)
    cache = PagedKVCache.create(cfg, 1, 1 + mppr, ps, max_pages_per_row=mppr,
                                quantized=True, device=dev)
    toks = torch.zeros((1, 128), dtype=torch.long)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
    _, k_all, v_all = fam.prefill(params, cfg, toks.to(dev),
                                  torch.tensor([n], device=dev),
                                  last_only=True)
    write_prefill_batch(cache, k_all, v_all, torch.tensor([0]),
                        torch.tensor([n]),
                        torch.arange(1, 1 + mppr, dtype=torch.int32)[None])
    block = torch.zeros((1, S), dtype=torch.long)
    block[0, :suf] = torch.randint(33, 126, (suf,), generator=gen)
    last = torch.tensor([suf - 1])
    name = f"wake verify_step_paged(last_idx) R=1 S={S}"

    def call(p, c, d):
        return fam.verify_step_paged(p, cfg, block.to(d), c, pages=mppr,
                                     last_idx=last.to(d))[0]

    c = _clone_cache(cache)
    before = _clone_cache(cache, "cpu")
    c0 = _launch_counts()
    with _Routes() as routes:
        logits = call(params, c, dev).float().cpu()
    moved = {k: v - c0[k] for k, v in _launch_counts().items() if v != c0[k]}
    check(moved.get("paged_attention_verify_append") == cfg.num_layers
          and any(k.startswith("quant_matmul") for k in moved),
          f"{name}: launches {moved}")
    return (name, call, logits, _clone_cache(c, "cpu"), before, routes, S,
            suf - 1)


def _verify_vs_cpu(label: str, params_cpu, runs) -> None:
    """Each card verify of :func:`_verify_runs` against the CPU's plain
    path from the same pool and weights: logits within STEP_TOL of
    max|logits|; the card's pool slots that the verify wrote (row 0's
    block; the parked row's land in the garbage page 0, not compared)
    within STEP_TOL of the CPU's (bf16 activations through kernels on
    one side, f32 plain math on the other, so k/v differ by rounding),
    and every other slot of the card's pool bitwise unchanged. On MoE
    models a position whose expert choice the two sides make differently
    (:class:`_Routes`; at most one a speculative run) is left out of the
    logits and named. A wake run (:func:`_wake_run`: logits at one
    position of an S-wide block) may see up to 5% of its positions choose
    differently: those positions' written k/v are left out of the pool
    check, and its logits are compared unless their own position is one
    of them (named)."""
    import torch
    for name, call, g, card_after, before, routes, S, last in runs:
        c = _clone_cache(before)
        with _Routes() as cpu_routes:
            cpu = call(params_cpu, c, torch.device("cpu")).float()
        check(bool(torch.isfinite(g).all()), f"{label} {name}: non-finite "
              "card logits")
        keep = torch.ones(g.shape[:2], dtype=torch.bool)
        flips = routes.flips(cpu_routes)
        skip = torch.zeros(S, dtype=torch.bool)
        if flips is not None and last is None:
            check(int(flips.sum()) <= 1, f"{label} {name}: expert choice "
                  f"differs at {flips.nonzero().tolist()}")
            keep &= ~flips
        elif flips is not None:
            check(float(flips[0].float().mean()) <= 0.05, f"{label} {name}: "
                  f"expert choice differs at {flips.nonzero().tolist()}")
            skip = flips[0]
            keep &= ~skip[last]
        err = (g - cpu)[keep].abs().max().item() if keep.any() else 0.0
        scale = cpu.abs().max().item()
        check(err <= STEP_TOL * scale, f"{label} {name}: logits err "
              f"{err:.4f} > {STEP_TOL} x {scale:.3f}")
        n = int(before.lengths[0])
        ps = before.page_size
        written = torch.zeros(before.k.shape[1:3], dtype=torch.bool)
        compared = torch.zeros(before.k.shape[1:3], dtype=torch.bool)
        for j in range(n, n + S):
            slot = (int(before.page_table[0, j // ps]), j % ps)
            written[slot] = True
            compared[slot] = not bool(skip[j - n])
        written[0] = True               # the garbage page
        compared[0] = False
        for f in ("k", "v"):
            a, b0 = getattr(card_after, f), getattr(before, f)
            check(torch.equal(a[:, ~written], b0[:, ~written]),
                  f"{label} {name}: pool {f} changed outside the block")
            ga = a.float()[:, compared]
            ca = getattr(c, f).float()[:, compared]
            e = (ga - ca).abs().max().item()
            check(e <= STEP_TOL * ca.abs().max().item(),
                  f"{label} {name}: written pool {f} err {e:.4f}")
        check(torch.equal(card_after.lengths, c.lengths), f"{label} {name}: "
              "lengths moved")
        flipped = ("" if flips is None or not flips.any() else
                   f" (positions {flips.nonzero()[:, 1].tolist()} left out: "
                   "their expert choice differs between card and CPU"
                   + ("; the logits' own position among them, logits not "
                      "compared" if not keep.any() else "") + ")")
        print(f"step: {label}: {name} (S={S}) card vs CPU plain logits "
              f"max_abs_err {err:.4f}, max|logits| {scale:.3f} (tol "
              f"{STEP_TOL:.0e} of max){flipped}; the written block within "
              "tol, the rest of the card's pool bitwise unchanged",
              flush=True)


def _spec_persistent(sched) -> dict:
    out = _persistent(sched)
    out["spec_out"] = sched._spec_out
    return out


def _spec_host(sched, rows) -> None:
    """Fill the spec input block: per row ``(tokens, drafts, max_acc,
    siblings)`` with siblings [(position, token, node)], the tree's base
    topology elsewhere; copied to the device."""
    host = sched._fill_spec_base()
    cols = sched._spec_cols
    for b, (toks, drafts, max_acc, sibs) in enumerate(rows):
        t0 = cols["tokens"].start
        host[b, t0:t0 + len(toks)] = toks
        d0 = cols["drafts"].start
        host[b, d0:d0 + len(drafts)] = drafts
        host[b, cols["max_acc"].start] = max_acc
        for j, tok, node in sibs:
            N = sched.spec_tree_nodes
            host[b, t0 + node] = tok
            host[b, cols["depths"].start + node] = j + 1
            a0 = cols["anc"].start + node * N
            host[b, a0:a0 + j + 1] = 1
            host[b, cols["sib_tok"].start + j] = tok
            host[b, cols["sib_node"].start + j] = node
    sched._spec_in.copy_(sched._spec_host)


def _spec_sched_checks(label: str, model: str, quant: str,
                       impl: str) -> None:
    """Spec ticks in the scheduler's state at full width, 2 layers (1 on
    mixtral-8x7b, :func:`_step_depth`), on
    quote weights (models/synth.quote_params: greedy output follows a
    fixed successor map by a wide margin, so drafts land): B = 8 rows
    63-480 tokens long over a random pool, the window's programs captured
    as the warmup does (the spec program verifies a tree of 8 nodes on
    the gather branch, a chain of K + 1 on write-then-attend). (1) Greedy
    verify equals K + 1 sequential decode steps: drafts = the first K
    of the sequential tokens, every row accepts K, the correction is the
    (K+1)-th token, and lengths, feed and rings equal the sequential
    steps' bitwise (keys advance by the verify's draws). (2) On the gather
    branch, a tree tick whose main chain is wrong at position 1 with the
    right token as a sibling leaf (node K + 1): every row uses the
    sibling (used_sib = 1, accepted 2, the correction the sequential
    third token), and copy_slot lands the sibling node's k/v (and int8
    scales) bitwise on the accepted slot, every layer. (3) The window's
    captured spec graph (tree on the gather branch, linear on
    write-then-attend) replayed from one state with greedy and sampled
    rows and mixed drafts: bitwise equal to the eager spec tick (pool,
    lengths, feed, keys, rings, outputs) with the same launch counts."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    cfg = get_config(model).with_(num_layers=_step_depth(model))
    params = quote_params(cfg, seed=7, quant=quant, device="cuda")
    wta = impl != "gather"
    B, w, K = 8, 512, 4
    sched = BatchScheduler(params, cfg, ByteTokenizer(cfg.vocab_size),
                           num_slots=B, max_seq=1024, page_size=64,
                           kv_quant=not wta, attn_impl=impl,
                           decode_fuse_max=4, spec_k=K,
                           spec_tree_nodes=0 if wta else 8, kv_mode="paged",
                           device="cuda")
    sched.stop()
    del params
    tree = bool(sched.spec_tree_nodes)
    sched._warm_window(w)
    gen = torch.Generator(device="cuda").manual_seed(11)
    _fill_decode_state(sched, [(w - 32) * (b + 1) // B for b in range(B)],
                       gen)
    sched._next.random_(33, 126, generator=gen)
    temps = sched._temps_dev.clone()
    sched._temps_dev.zero_()
    s0 = _spec_snapshot(sched)
    chain = []
    for _ in range(K + 1):
        sched._step_fn(w, 1)()
        chain.append(sched._toks_out[1][0].clone())
    seq = _snapshot(sched)
    chain = torch.stack(chain, 1).cpu()                    # [B, K + 1]
    nxt = s0["next"][:, 0].cpu()
    pad = [0] * ((sched.spec_tree_nodes or K + 1) - K - 1)
    _restore(sched, s0)
    _spec_host(sched, [([int(nxt[b])] + chain[b, :K].tolist() + pad,
                        chain[b, :K].tolist(), K, []) for b in range(B)])
    sched._spec_fn(w)()
    acc, corr, used = sched._spec_out.cpu()
    check(acc.tolist() == [K] * B and torch.equal(corr, chain[:, K]),
          f"step {label}: greedy verify accepted {acc.tolist()}, "
          f"correction {corr.tolist()}; sequential {chain.tolist()}")
    got = _snapshot(sched)
    if tree:     # the tree draws one more uniform (the sibling's)
        seq["keys"] = s0["keys"] + torch.tensor([0, K + 2],
                                                device=s0["keys"].device)
    for name in ("lengths", "next", "keys", "ring"):
        check(torch.equal(got[name], seq[name]), f"step {label}: greedy "
              f"verify's {name} differs from {K + 1} sequential steps")
    msg = (f"greedy verify of {K} drafts equals {K + 1} sequential steps "
           "(tokens, lengths, feed, rings; keys advanced by the draws)")
    if tree:
        _restore(sched, s0)
        wrong = [(int(t) - 32 + 7) % 95 + 32 for t in chain[:, 1]]
        _spec_host(sched, [
            ([int(nxt[b]), int(chain[b, 0]), wrong[b], int(chain[b, 2]),
              int(chain[b, 3])],
             [int(chain[b, 0]), wrong[b], int(chain[b, 2]),
              int(chain[b, 3])], K, [(1, int(chain[b, 1]), K + 1)])
            for b in range(B)])
        pre = sched._cache.lengths.clone().long()
        sched._spec_fn(w)()
        acc, corr, used = sched._spec_out.cpu()
        check(used.tolist() == [1] * B and acc.tolist() == [2] * B
              and torch.equal(corr, chain[:, 2]), f"step {label}: sibling "
              f"tick used {used.tolist()}, accepted {acc.tolist()}, "
              f"correction {corr.tolist()} (want {chain[:, 2].tolist()})")
        c, ps = sched._cache, sched.page_size
        for b in range(B):
            slots = []
            for pos in (int(pre[b]) + 2, int(pre[b]) + K + 1):
                slots.append((int(c.page_table[b, pos // ps]), pos % ps))
            (pd, sd), (pn, sn) = slots
            for f in ("k", "v"):
                t = getattr(c, f)
                check(torch.equal(t[:, pd, sd], t[:, pn, sn]),
                      f"step {label}: row {b}: sibling {f} not moved")
            if c.k_scale is not None:
                for f in ("k_scale", "v_scale"):
                    t = getattr(c, f)
                    check(torch.equal(t[:, pd, :, sd], t[:, pn, :, sn]),
                          f"step {label}: row {b}: sibling {f} not moved")
        msg += ("; tree tick with a sibling at position 1: used on every "
                "row, its k/v moved bitwise onto the accepted slot")
    _restore(sched, s0)
    sched._temps_dev.copy_(temps)
    rows = []
    for b in range(B):
        d = (chain[b, :K].tolist() if b % 2 == 0 else
             torch.randint(33, 126, (K,)).tolist())
        rows.append(([int(nxt[b])] + d + pad, d, b % (K + 1), []))
    s1 = _spec_snapshot(sched)
    _spec_host(sched, rows)
    c0 = _launch_counts()
    sched._spec_fn(w)()
    eager_n = {n: v - c0[n] for n, v in _launch_counts().items()
               if v != c0[n]}
    eager = _spec_snapshot(sched)
    _restore(sched, s1)
    sched._spec_out.copy_(s1["spec_out"])
    prog = sched._spec_for(w)
    check(prog.graph is not None, f"step {label}: no spec graph captured")
    c0 = _launch_counts()
    prog()
    replay_n = {n: v - c0[n] for n, v in _launch_counts().items()
                if v != c0[n]}
    _bitwise(f"step {label}: spec graph replay vs eager spec tick", eager,
             _spec_snapshot(sched))
    check(replay_n == eager_n, f"step {label}: a spec replay counts "
          f"{replay_n}, the eager tick launched {eager_n}")
    torch.cuda.synchronize()
    print(f"step: {label} spec ({cfg.num_layers} layers, quote weights, "
          f"B={B}, W={w}, "
          f"K={K}, {'tree N=8' if tree else 'linear'}): {msg}; the spec "
          f"graph's replay bitwise equal to the eager tick (accepted "
          f"{eager['spec_out'][0].tolist()}), launches per replay "
          f"{replay_n}", flush=True)


def _spec_snapshot(sched) -> dict:
    return {n: t.clone() for n, t in _spec_persistent(sched).items()}


# Texts of the embed legs (a text of n bytes is n + 1 tokens with BOS,
# and S is the power of two above the longest): two, the longer of 128-254
# bytes (R = 2, S = 256: the dense projections at 512 rows go to kernel A
# or C), four, the longest of 64-126 (R = 4, S = 128: 512 rows again),
# five with one of 1,500 bytes (R = 8, S = 2048: the dequantize path,
# kernel D at R = 8), and twelve of at most 254 (R = 16, S = 256: a whole
# chunk of 16 rows).
EMBED_SHORT = ["see you at noon?", "The co-pilot drafts a friendly reply "
               "to the last message of the conversation, keeping the tone of "
               "the thread and the plans it already holds."]
EMBED_QUAD = ["hi", "how are you?", "lunch tomorrow works for me, the usual "
              "place at half past twelve if that suits", "ok"]
EMBED_LONG = ["short one", "are we still on for lunch tomorrow?",
              ("The co-pilot reads the whole conversation before it drafts "
               "a reply. " * 40)[:1500], "thanks!", "sounds good to me"]
EMBED_WIDE = EMBED_SHORT + EMBED_QUAD + [
    "running five minutes late", "can you send the address?", "yes",
    "what time works for you?", "see you there", "great, thanks!"]
EMBED_SHAPES = {"short": (2, 256), "quad": (4, 128), "long": (8, 2048),
                "wide": (16, 256)}
EMBED_TOL = 1e-3    # cosine 0.999, card vs CPU: bf16 activations through
#                     2 layers rounded at different places on the two
#                     paths (STEP_TOL's reason), averaged over the text


def _embed_shapes(texts, vocab_size: int) -> list:
    """The (R, S) of each chunk the engine makes of ``texts``
    (serve/engine.embed_batches at max_seq 4096)."""
    from p2p_llm_chat_tpu_torch.serve.engine import embed_batches
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    tok = ByteTokenizer(vocab_size)
    ids = [tok.encode(t, add_bos=True) for t in texts]
    return [tuple(toks.shape) for _, toks, _ in embed_batches(ids, 4096)]


def _check_embed_shapes(vocab_size: int) -> None:
    """Each group of embed texts makes the one chunk its labels name."""
    for name, want in EMBED_SHAPES.items():
        got = _embed_shapes(globals()[f"EMBED_{name.upper()}"], vocab_size)
        check(got == [want], f"EMBED_{name.upper()} makes chunks {got}, "
              f"not {[want]}")


def _embed_vectors(fam, params, cfg, groups, device):
    """``embed_pooled`` over each group of texts, bucketed as the engine
    does (serve/engine.embed_batches); [n, H] f32 on the host."""
    import torch
    from p2p_llm_chat_tpu_torch.serve.engine import embed_batches
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    tok = ByteTokenizer(cfg.vocab_size)
    out = []
    for texts in groups:
        ids = [tok.encode(t, add_bos=True) for t in texts]
        for n, toks, lens in embed_batches(ids, 4096):
            out.append(fam.embed_pooled(params, cfg, toks.to(device),
                                        lens.to(device))[:n].float().cpu())
    return torch.cat(out)


def _cosines(a, b):
    import torch
    return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                              * torch.linalg.vector_norm(b, dim=-1))


def _step_depth(model: str) -> int:
    """The step phases' depth cut: 2 layers; mixtral-8x7b 1, its CPU
    plain forwards at full width (17 s a decode step, more for the wake's
    S = 256) being most of the default run's step time."""
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    return 1 if get_config(model).is_moe else 2


def phase_step(model: str, quant: str, prefill_check: bool,
               impl: str = "gather") -> None:
    """One decode step of ``model`` at full width, depth cut to 2 layers
    (1 on mixtral-8x7b, :func:`_step_depth`),
    ``quant`` weights + an int8 pool (a bf16 pool under a write-then-attend
    ``impl``, kernel B's pool mode): the prompt is prefilled on the card,
    then the same step runs through the kernels on the card and through
    the plain path on the CPU from the same weights and pool. With
    ``prefill_check``, also a 200-token prefill (bucket 256, kernel D) on
    the card against the plain prefill on the CPU, and a 700-token prompt
    prefilled in 4 chunks of 256 against its whole-prompt prefill (bucket
    1024), both on the card; and ``embed_pooled`` of six texts (R = 2 at
    S = 256, R = 4 at S = 128: kernel A or the expert grid, and kernel D)
    on the card against the CPU's plain path, cosine >= 0.999 each."""
    import torch
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.quant import QTensor, QTensor4
    from p2p_llm_chat_tpu_torch.ops.paged_kv import (PagedKVCache,
                                                     write_prefill_batch)
    cfg = get_config(model).with_(num_layers=_step_depth(model))
    fam = family_for(cfg)
    dev = torch.device("cuda")
    params = fam.init_params_quantized(cfg, seed=7, quant=quant, device=dev)

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, (QTensor, QTensor4)):
            return type(t)(t.q.cpu(), t.s.cpu())
        return t.cpu()

    gen = torch.Generator().manual_seed(3)
    n = 100
    S = 128
    toks = torch.zeros((1, S), dtype=torch.long)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
    lens = torch.tensor([n])
    ps, B, mppr = 64, 2, 4
    wta = impl != "gather"
    cache = PagedKVCache.create(cfg, B, 1 + B * mppr, ps,
                                max_pages_per_row=mppr, quantized=not wta,
                                device=dev)
    logits, k_all, v_all = fam.prefill(params, cfg, toks.to(dev),
                                       lens.to(dev), last_only=True)
    tables = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    write_prefill_batch(cache, k_all, v_all, torch.tensor([0]), lens, tables)
    cpu_cache = PagedKVCache(*(None if t is None else t.cpu() for t in (
        cache.k, cache.v, cache.page_table, cache.lengths, cache.k_scale,
        cache.v_scale)))
    tok = logits[:, 0].argmax(-1).reshape(1, 1)
    tokens = torch.cat([tok, torch.zeros_like(tok)])     # row 1 parked
    active = torch.tensor([True, False])
    pages = -(-(n + wta) // ps)
    verify = _verify_runs(fam, params, cfg, cache, impl)
    if not wta and (not cfg.is_moe or quant == "int4"):
        # A session wake's forward (R = 1, S = 256) on llama int8 and
        # mixtral int4.
        verify.append(_wake_run(fam, params, cfg))
    launched = {k: f.launches for k, f in _wrappers().items()}
    out_gpu, _ = fam.decode_step_paged(params, cfg, tokens, cache,
                                       active.to(dev), pages=pages,
                                       impl=impl)
    attn = "paged_attention" if wta else "paged_attention_append"
    check(_wrappers()[attn].launches - launched[attn] == cfg.num_layers,
          f"step {model} impl={impl}: {attn} was not launched on every "
          "layer")
    if prefill_check:
        pn, pS = 200, 256
        ptoks = torch.zeros((1, pS), dtype=torch.long)
        ptoks[0, :pn] = torch.randint(0, cfg.vocab_size, (pn,), generator=gen)
        plens = torch.tensor([pn])
        d_before = _wrappers()["prefill_attention"].launches
        pre_gpu = fam.prefill(params, cfg, ptoks.to(dev), plens.to(dev),
                              last_only=True)[0][0, 0].float().cpu()
        check(_wrappers()["prefill_attention"].launches - d_before
              == cfg.num_layers, f"step {model}: the card prefill did not "
              "run kernel D on every layer")
        cn, cS, C = 700, 1024, 256
        ctoks = torch.zeros((1, cS), dtype=torch.long)
        ctoks[0, :cn] = torch.randint(0, cfg.vocab_size, (cn,),
                                      generator=gen)
        whole = fam.prefill(params, cfg, ctoks.to(dev),
                            torch.tensor([cn], device=dev),
                            last_only=True)[0][0, 0].float()
        chunked = _chunked_prefill(fam, params, cfg, ctoks.to(dev), cn,
                                   C)[0].float()
        check(bool(torch.isfinite(chunked).all()), f"step {model}: "
              "non-finite chunked-prefill logits")
        err = (chunked - whole).abs().max().item()
        scale = whole.abs().max().item()
        print(f"step: {model} dims, {cfg.num_layers} layers, {quant} weights: "
              f"prompt {cn} "
              f"in {cS // C} chunks of {C} vs whole-prompt prefill on the "
              f"card: logits max_abs_err {err:.4f}, max|logits| {scale:.3f} "
              f"(tol {STEP_TOL:.0e} of max), argmax "
              f"{'equal' if int(chunked.argmax()) == int(whole.argmax()) else 'differs'}")
        check(err <= STEP_TOL * scale, f"step {model} {quant}: chunked "
              f"prefill err {err:.4f} > {STEP_TOL} x {scale:.3f}")
        _check_embed_shapes(cfg.vocab_size)
        c0 = _launch_counts()
        emb_gpu = _embed_vectors(fam, params, cfg, (EMBED_SHORT, EMBED_QUAD),
                                 dev)
        moved = {n: v - c0[n] for n, v in _launch_counts().items()
                 if v != c0[n]}
        mm = ("quant_matmul_experts_stacked" if cfg.is_moe
              else "quant_matmul")
        check(moved.get(mm, 0) > 0 and moved.get("prefill_attention")
              == 2 * cfg.num_layers, f"step {model}: the card embed "
              f"launched {moved}")
    _graph_checks(f"{model} {quant} impl={impl}", cfg, params, impl,
                  quantized=not wta)
    torch.cuda.synchronize()
    params_cpu = to_cpu(params)
    del params, logits, k_all, v_all
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out_cpu, _ = fam.decode_step_paged(params_cpu, cfg, tokens.cpu(),
                                       cpu_cache, active, pages=pages,
                                       impl=impl)
    cpu_s = time.monotonic() - t0
    g, c = out_gpu[0, 0].float().cpu(), out_cpu[0, 0].float()
    check(bool(torch.isfinite(g).all()), f"step {model}: non-finite card "
          "logits")
    err = (g - c).abs().max().item()
    scale = c.abs().max().item()
    same = int(g.argmax()) == int(c.argmax())
    print(f"step: {model} dims, {cfg.num_layers} layers, {quant} weights + "
          f"{'bf16 pool, write-then-attend' if wta else 'int8 pool'} "
          f"(impl={impl}), prompt {n}: card vs CPU plain logits max_abs_err "
          f"{err:.4f}, "
          f"max|logits| {scale:.3f} (tol {STEP_TOL:.0e} of max), argmax "
          f"{'equal' if same else 'differs'}; CPU step {cpu_s:.1f} s")
    check(err <= STEP_TOL * scale, f"step {model} {quant}: logits err "
          f"{err:.4f} > {STEP_TOL} x {scale:.3f}")
    if cfg.is_moe or wta:
        check(same, f"step {model} {quant} impl={impl}: argmax differs")
    check(torch.equal(cache.lengths.cpu(), cpu_cache.lengths),
          f"step {model}: lengths differ")
    _verify_vs_cpu(f"{model} {quant} impl={impl}", params_cpu, verify)
    if wta:    # both pools hold the step's k/v, one bf16 rounding apart
        live = cache.page_table[0, :pages].long().cpu()
        for name in ("k", "v"):
            g = getattr(cache, name)[:, live].float().cpu()
            c = getattr(cpu_cache, name)[:, live].float()
            err = (g - c).abs().max().item()
            check(err <= STEP_TOL * c.abs().max().item(),
                  f"step {model} impl={impl}: pool {name} err {err:.4f}")
    if prefill_check:
        t0 = time.monotonic()
        pre_cpu = fam.prefill(params_cpu, cfg, ptoks, plens,
                              last_only=True)[0][0, 0].float()
        cpu_s = time.monotonic() - t0
        check(bool(torch.isfinite(pre_gpu).all()), f"step {model}: "
              "non-finite card prefill logits")
        err = (pre_gpu - pre_cpu).abs().max().item()
        scale = pre_cpu.abs().max().item()
        same = int(pre_gpu.argmax()) == int(pre_cpu.argmax())
        print(f"step: {model} dims, {cfg.num_layers} layers, {quant} weights: "
              f"prefill of "
              f"{pn} tokens (bucket {pS}, kernel D) card vs CPU plain "
              f"logits max_abs_err {err:.4f}, max|logits| {scale:.3f} (tol "
              f"{STEP_TOL:.0e} of max), argmax "
              f"{'equal' if same else 'differs'}; CPU prefill {cpu_s:.1f} s")
        check(err <= STEP_TOL * scale, f"step {model} {quant}: prefill "
              f"logits err {err:.4f} > {STEP_TOL} x {scale:.3f}")
        check(same, f"step {model} {quant}: prefill argmax differs")
        t0 = time.monotonic()
        emb_cpu = _embed_vectors(fam, params_cpu, cfg,
                                 (EMBED_SHORT, EMBED_QUAD), "cpu")
        cpu_s = time.monotonic() - t0
        check(bool(torch.isfinite(emb_gpu).all()), f"step {model}: "
              "non-finite card embeddings")
        cos = _cosines(emb_gpu, emb_cpu)
        print(f"embed: {model} dims, {cfg.num_layers} layers, {quant} "
              "weights: "
              f"{len(cos)} texts (R=2 at S=256, R=4 at S=128; launches "
              f"{moved}) card vs CPU plain: cosine min "
              f"{cos.min().item():.6f} (tol {1 - EMBED_TOL}), max_abs_err "
              f"{(emb_gpu - emb_cpu).abs().max().item():.5f}; CPU embed "
              f"{cpu_s:.1f} s")
        check(bool((cos >= 1 - EMBED_TOL).all()), f"step {model} {quant}: "
              f"embed cosines {cos.tolist()} < {1 - EMBED_TOL}")
    del params_cpu
    _spec_sched_checks(f"{model} {quant} impl={impl}", model, quant, impl)


def _int8_kv_writes() -> None:
    """The int8 pool's writes on the card against the CPU's, bitwise: the
    same k/v (head rows of amax 10^-3 to 10^3) through write_prefill_batch
    then write_decode into a card pool and a CPU pool, int8 bytes and f32
    scales compared; and how many of those rows' scales the reciprocal
    form ``amax / 127.0`` (a Python scalar, which CUDA multiplies by its
    reciprocal) would have put one ulp off the IEEE quotient."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.ops.paged_kv import (PagedKVCache,
                                                     write_decode,
                                                     write_prefill_batch)
    cfg = get_config("llama3.1-8b").with_(num_layers=2)
    gen = torch.Generator().manual_seed(21)
    L, R, S, Hkv, D = 2, 2, 128, cfg.num_kv_heads, cfg.head_dim
    mag = 10.0 ** torch.randint(-3, 4, (L, R, S, Hkv, 1), generator=gen)
    k = (torch.randn((L, R, S, Hkv, D), generator=gen) * mag).to(
        torch.bfloat16)
    v = (torch.randn((L, R, S, Hkv, D), generator=gen) * mag).to(
        torch.bfloat16)
    kd = (torch.randn((R, Hkv, D), generator=gen) * 37.0).to(torch.bfloat16)
    pools = []
    for dev in ("cuda", "cpu"):
        c = PagedKVCache.create(cfg, R, 1 + 2 * R + 1, 64,
                                max_pages_per_row=3, quantized=True,
                                device=dev)
        write_prefill_batch(c, k.to(dev), v.to(dev), torch.arange(R),
                            torch.tensor([S, S - 9]),
                            torch.tensor([[1, 2, 0], [3, 4, 5]]))
        write_decode(c, 1, kd.to(dev), (kd * 0.5).to(dev))
        pools.append(c)
    g, c = pools
    for name in ("k", "v", "k_scale", "v_scale"):
        check(torch.equal(getattr(g, name).cpu(), getattr(c, name)),
              f"int8 KV writes: {name} differs between the card and the CPU")
    amax = k.float().abs().amax(-1).flatten().cuda()
    recip = amax / 127.0
    quot = amax / torch.full((), 127.0, device="cuda")
    n_off = int((recip != quot).sum())
    print(f"step: int8 pool writes (write_prefill_batch + write_decode, "
          f"{amax.numel()} head rows of amax 1e-3..1e3): bytes and scales "
          f"bitwise equal on the card and the CPU; the reciprocal form "
          f"amax / 127.0 on the card is off the IEEE quotient on {n_off} "
          f"of them", flush=True)


def _dense_clone(cache, device=None):
    from p2p_llm_chat_tpu_torch.models.llama import KVCache
    return KVCache(*(t.clone().to(device or t.device)
                     for t in (cache.k, cache.v, cache.lengths)),
                   cache.max_seq)


def phase_step_dense(model: str, quant: str) -> None:
    """The dense KV path's forwards of ``model`` at full width, depth cut
    to 2 layers (1 on mixtral-8x7b), ``quant`` weights, bf16 dense cache
    (B = 2, max_seq
    1024): two prompts prefilled into the cache (kernel D), then on the
    card and from the same cache on the CPU's plain path: ``decode_step``
    (row 1 parked), ``verify_step`` at S = 5 (llama; mixtral's CPU expert
    path costs 15 s a call, and its chain runs the tree's code) and
    ``verify_tree`` over 8 nodes (a chain of 5 and 3 siblings), each
    within STEP_TOL of the
    logit scale with the cache's written slots within STEP_TOL and the
    rest bitwise unchanged, A8 launched on every layer; on the card,
    ``decode_fused`` at K = 4 bitwise equal to 4 ``decode_step`` calls.
    Then the scheduler's dense decode programs at B = 8 (the graph checks
    of the paged phases: the K = 1 replay bitwise against the eager step,
    the K = 4 replay against four K = 1 replays and eager
    ``decode_fused``). On llama also the int8 pool's writes against the
    CPU's, bitwise."""
    import torch
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.llama import KVCache
    from p2p_llm_chat_tpu_torch.models.quant import QTensor, QTensor4
    if not get_config(model).is_moe:
        _int8_kv_writes()
    cfg = get_config(model).with_(num_layers=_step_depth(model))
    fam = family_for(cfg)
    dev = torch.device("cuda")
    params = fam.init_params_quantized(cfg, seed=7, quant=quant, device=dev)

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, (QTensor, QTensor4)):
            return type(t)(t.q.cpu(), t.s.cpu())
        return t.cpu()

    gen = torch.Generator().manual_seed(5)
    B, T, S0, W = 2, 1024, 128, 256
    lens = torch.tensor([100, 37])
    toks = torch.zeros((B, S0), dtype=torch.long)
    for b in range(B):
        toks[b, :lens[b]] = torch.randint(0, cfg.vocab_size, (int(lens[b]),),
                                          generator=gen)
    cache = KVCache.create(cfg, B, T, device=dev)
    c0 = _launch_counts()
    logits, _ = fam.prefill(params, cfg, toks.to(dev), lens.to(dev),
                            last_only=True, cache=cache)
    check(_launch_counts()["prefill_attention"] - c0["prefill_attention"]
          == cfg.num_layers, f"step dense {model}: the prefill did not run "
          "kernel D on every layer")
    tok = logits[:, 0].argmax(-1)[:, None]
    runs = []                   # (name, card cache before, fn, logits, after)

    def run(name, fn, attn, n_launch):
        before = _dense_clone(cache, "cpu")
        c0 = _launch_counts()
        out = fn(params, cache)
        got = _launch_counts()[attn] - c0[attn]
        check(got == n_launch, f"step dense {model}: {name} launched {attn} "
              f"{got} times, want {n_launch}")
        runs.append((name, before, fn, out.float().cpu(),
                     _dense_clone(cache, "cpu")))

    active = torch.tensor([True, False], device=dev)
    run("decode_step", lambda p, c: fam.decode_step(
        p, cfg, tok.to(c.k.device), c, active.to(c.k.device),
        kv_window=W)[0], "dense_attention", cfg.num_layers)
    vt = torch.randint(0, cfg.vocab_size, (B, 5), generator=gen)
    if not cfg.is_moe:     # mixtral's chain verify: the tree's code path
        run("verify_step S=5", lambda p, c: fam.verify_step(
            p, cfg, vt.to(c.k.device), c, kv_window=W)[0],
            "dense_attention_verify", cfg.num_layers)
    N = 8
    depths = torch.tensor([0, 1, 2, 3, 4, 1, 2, 3]).repeat(B, 1)
    parent = [-1, 0, 1, 2, 3, 0, 1, 2]
    anc = torch.zeros((N, N), dtype=torch.bool)
    for i in range(N):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = parent[j]
    anc = anc.repeat(B, 1, 1)
    nt = torch.randint(0, cfg.vocab_size, (B, N), generator=gen)
    run("verify_tree N=8", lambda p, c: fam.verify_tree(
        p, cfg, nt.to(c.k.device), depths.to(c.k.device),
        anc.to(c.k.device), c, kv_window=W)[0],
        "dense_attention_verify", cfg.num_layers)
    # decode_fused K = 4 (argmax) against four decode_step calls, on the
    # card, bitwise.
    start = _dense_clone(cache)

    def argmax_fn(lg, state, emit_pos, act):
        return lg.argmax(-1), state

    seq_cache, t, seq = _dense_clone(start), tok, []
    for _ in range(4):
        lg, _ = fam.decode_step(params, cfg, t, seq_cache, kv_window=W)
        t = lg[:, 0].argmax(-1)[:, None]
        seq.append(t[:, 0])
    fused_cache = _dense_clone(start)
    ftoks, *_ = fam.decode_fused(
        params, cfg, tok, fused_cache, None, num_steps=4,
        sample_fn=argmax_fn, sample_state=None,
        stop_ids=torch.zeros((0,), dtype=torch.long, device=dev),
        kv_window=W)
    check(torch.equal(ftoks, torch.stack(seq))
          and torch.equal(fused_cache.k, seq_cache.k)
          and torch.equal(fused_cache.lengths, seq_cache.lengths),
          f"step dense {model}: decode_fused K=4 differs from 4 steps")
    print(f"step dense: {model} dims, {cfg.num_layers} layers, {quant} "
          f"weights: "
          f"decode_fused K=4 bitwise equal to 4 decode_step calls; tokens "
          f"{torch.stack(seq).tolist()}", flush=True)
    _graph_checks(f"{model} {quant} dense", cfg, params, "gather",
                  quantized=False, kv_mode="dense")
    torch.cuda.synchronize()
    params_cpu = to_cpu(params)
    del params, start, seq_cache, fused_cache
    torch.cuda.empty_cache()
    for name, before, fn, got, after in runs:
        t0 = time.monotonic()
        c = _dense_clone(before)
        want = fn(params_cpu, c).float()
        cpu_s = time.monotonic() - t0
        check(bool(torch.isfinite(got).all()), f"step dense {model} {name}: "
              "non-finite card logits")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        same = bool((got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.5)
        changed = (c.k != before.k).any(dim=(0, 3, 4))
        k_err = (after.k.float() - c.k.float())[:, changed].abs().max().item()
        print(f"step dense: {model} dims, {cfg.num_layers} layers, "
              f"{quant} weights, "
              f"{name}: card vs CPU plain logits max_abs_err {err:.4f}, "
              f"max|logits| {scale:.3f} (tol {STEP_TOL:.0e} of max), argmax "
              f"{'mostly equal' if same else 'differs'}; written slots "
              f"{int(changed.sum())}, k max_abs_err {k_err:.4f}; CPU "
              f"{cpu_s:.1f} s", flush=True)
        check(err <= STEP_TOL * scale, f"step dense {model} {name}: logits "
              f"err {err:.4f} > {STEP_TOL} x {scale:.3f}")
        check(k_err <= STEP_TOL * c.k.float().abs().max().item(),
              f"step dense {model} {name}: written k err {k_err:.4f}")
        check(torch.equal(after.k[:, ~changed], before.k[:, ~changed])
              and torch.equal(after.lengths, c.lengths),
              f"step dense {model} {name}: the card wrote outside the "
              "CPU's slots, or lengths differ")


# -- optional phase: where one full-depth decode step spends its time ---------
# The attribution (device events by kernel group, unions of their
# intervals, the idle share) is p2p_llm_chat_tpu_torch/tools/trace_step.py.

def phase_profile(results: dict, model: str, quant: str, B: int = 8,
                  W: int = 1020, steps: int = 10,
                  impl: str = "gather") -> None:
    """Where one ``model`` decode step (32 layers, ``quant`` weights, an
    int8 pool; under a write-then-attend ``impl`` a bf16 pool) spends its
    time at ``B`` rows of ``W`` pool tokens, in the scheduler's state and
    at its window (1024: W + 4 fits it, so K = 1 and K = 4 share it),
    four ways: the bare eager ``decode_step_paged``; the eager tick
    (the step, the device sampler and the write-backs: the K = 1 program
    without a graph); and the K = 1 and K = 4 programs replayed from their
    CUDA graphs. Each: wall time per step with CUDA events over ``steps``
    calls, then a torch.profiler pass summing device time by kernel and
    the device's idle share of the wall time (tools/trace_step.attribute).
    On llama3.1-8b's gather branch (profile_llama), tools/profile_step's
    ``full`` variant on the same weights and state is then attributed the
    same way, and its device busy time kept beside the bare step's as
    ``_profile_llama_step_ms`` for phase_profile_tools (device busy, not a
    graph replay's time: replays of one captured step run at two levels
    about 6% apart, by capture, tools/card.py). Not part of the default
    run."""
    import torch
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    from p2p_llm_chat_tpu_torch.tools import profile_step, trace_step
    cfg = get_config(model)
    fam = family_for(cfg)
    print(f"profile: building {model} ({quant}); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before",
          flush=True)
    params = fam.init_params_quantized(cfg, seed=5, quant=quant,
                                       device="cuda")
    wta = impl != "gather"
    window = 1024
    sched = BatchScheduler(params, cfg, ByteTokenizer(cfg.vocab_size),
                           num_slots=B, max_seq=2 * window, page_size=64,
                           kv_quant=not wta, attn_impl=impl,
                           decode_fuse_max=4, kv_mode="paged", device="cuda")
    sched.stop()
    t0 = time.monotonic()
    sched._warm_window(window)
    torch.cuda.synchronize()
    cap_s = time.monotonic() - t0
    gen = torch.Generator(device="cuda").manual_seed(5)
    _fill_decode_state(sched, [W] * B, gen)
    sched._temps_dev.zero_()
    cache = sched._cache
    pages = window // 64

    def bare() -> None:
        fam.decode_step_paged(params, cfg, sched._next, cache,
                              sched._active_dev, pages=pages, impl=impl)

    variants = (("eager step (decode_step_paged)", bare, 1),
                ("eager tick (step + device sampler, no graph)",
                 sched._step_fn(window, 1), 1),
                ("graph K=1 replay", sched._decode_for(window), 1),
                ("graph K=4 replay", sched._decode_fused_for(window, 4), 4))
    print(f"profile: {model} decode, 32 layers, {quant} weights + "
          f"{'bf16 pool (write-then-attend)' if wta else 'int8 pool'}, "
          f"B={B} W={W}, window {window}: {len(sched._programs)} graphs "
          f"captured in {cap_s:.1f} s", flush=True)
    tools_full = model == "llama3.1-8b" and not wta
    if tools_full:
        variants += (("tools/profile_step full variant (eager)",
                      lambda: profile_step.step_variant(
                          params, cfg, sched._next, cache, pages=pages,
                          variant="full"), 1),)
    busy = {}
    for label, fn, K in variants:
        def call(_i: int = 0, fn=fn) -> None:
            cache.lengths.fill_(W)
            fn()
        out = trace_step.attribute(label, call, steps, K=K)
        busy[label] = out["busy_ms"]
        if K == 1 and "graph" not in label:
            check(out["busy_ms"] > 0, "profile: the profiler saw no device "
                  "time")
    if tools_full:
        results["_profile_llama_step_ms"] = {
            "step": busy[variants[0][0]], "full": busy[variants[-1][0]]}


def phase_profile_prefill(model: str, quant: str, S: int = 2048,
                          C: int = 256, reps: int = 3) -> None:
    """One 32-layer ``model`` prefill of an ``S``-token prompt (R = 1),
    whole and as ``S // C`` chunks of ``C`` (the scheduler's chunked
    admission): wall time with CUDA events, then device time by kernel
    with torch.profiler, and the dequantize of every > 512-row projection
    timed apart (its elementwise kernels fall under "other")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.quant import dequantize
    from p2p_llm_chat_tpu_torch.tools import trace_step
    cfg = get_config(model)
    fam = family_for(cfg)
    dev = torch.device("cuda")
    params = fam.init_params_quantized(cfg, seed=6, quant=quant, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, 256, (1, S), generator=gen, device=dev)
    lens = torch.tensor([S], device=dev)

    def whole(_i: int = 0) -> None:
        fam.prefill(params, cfg, toks, lens, last_only=True)

    def chunked(_i: int = 0) -> None:
        _chunked_prefill(fam, params, cfg, toks, S, C)

    layers = params["layers"]
    names = [n for n in ("wqkv", "wo", "wgu", "w_down") if n in layers]
    deq = time_ms(lambda i: [dequantize(type(layers[n])(
        layers[n].q[i % cfg.num_layers], layers[n].s[i % cfg.num_layers]),
        torch.bfloat16) for n in names], cfg.num_layers, warmup=1)
    for label, fn in (("whole prompt", whole),
                      (f"{S // C} chunks of {C}", chunked)):
        wall = time_ms(fn, reps, warmup=1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups: dict[str, list] = {}
        reduce_ms = 0.0          # kernel A's split-K reduce, within its group
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            acc = groups.setdefault(trace_step.prefill_group(e.name),
                                    [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
            if "qmm_reduce" in e.name:
                reduce_ms += e.time_range.elapsed_us() / 1e3
        busy = sum(v[0] for v in groups.values())
        check(busy > 0, "profile_prefill: the profiler saw no device time")
        print(f"profile: {model} prefill, 32 layers, {quant} weights, R=1, "
              f"S={S}, {label}: {wall:.3f} ms (CUDA events, {reps} runs, no "
              f"profiler); device busy {busy:.3f} ms -> idle share "
              f"{max(0.0, 1 - busy / wall):.1%}")
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {g}: {ms:.3f} ms over {n} launches ({ms / busy:.1%} "
                  "of device time)")
        print(f"    of kernel A, its split-K reduce: {reduce_ms:.3f} ms")
    print(f"profile: dequantize of {len(names)} projections x "
          f"{cfg.num_layers} layers (what the whole-prompt path runs before "
          f"its matmuls): {deq * cfg.num_layers:.3f} ms")


PROFILE_STEP_TOL = 0.05   # profile_step's full vs profile_llama's step


def phase_profile_tools(results: dict) -> None:
    """The tool twins (p2p_llm_chat_tpu_torch/tools/) on the card, after
    profile_llama in the same run: profile_step's variants on llama3.1-8b
    int8 weights over an int8 pool at B = 8, window 1024, 1020 tokens a
    row (profile_llama's state), each timed from CUDA graphs at two
    lengths, once its ``full`` variant is held within PROFILE_STEP_TOL of
    profile_llama's step (the device busy time of each, attributed there
    on the same weights and state); check_quant_kernel at llama3.1-8b's fused
    gate|up (int8, kernel A); check_append_kernel at the reference's first
    case; time_append_kernel once. Not part of the default run."""
    import torch
    from p2p_llm_chat_tpu_torch.tools import (check_append_kernel,
                                              check_quant_kernel,
                                              profile_step,
                                              time_append_kernel)
    dev = torch.device("cuda")
    pair = results.get("_profile_llama_step_ms")
    check(pair is not None, "profile_tools: run it after profile_llama "
          "(--only build,profile)")
    want = pair["step"]
    off = abs(pair["full"] - want) / want
    print(f"profile_tools: profile_step's full variant {pair['full']:.3f} ms "
          f"against profile_llama's step {want:.3f} ms (device busy a step, "
          f"torch.profiler, on its weights and state): {off:.1%} apart "
          f"[card: {card_line()}]", flush=True)
    check(off <= PROFILE_STEP_TOL, f"profile_tools: profile_step's full "
          f"variant is {off:.1%} from profile_llama's step")
    steps = profile_step.run(
        profile_step.VARIANTS, config="llama3.1-8b", slots=8, window=1024,
        length=1020, kv_quant=True, steps=16, dev=dev,
        show=lambda t: print(f"  {t}", flush=True))
    quant = check_quant_kernel.check("int8", 4096, 28672, False, dev,
                                     show=lambda t: print(f"  {t}"))
    append_err = check_append_kernel.run(*check_append_kernel.CASES[0],
                                         config="bench-1b", B=32, dev=dev,
                                         show=lambda t: print(f"  {t}"))
    walk = time_append_kernel.main(["--device", "cuda"])
    results["_profile_tools"] = {
        "profile_step_ms": {k: v for k, v in steps.items() if v is not None},
        "profile_llama_step_ms": pair, "full_vs_profile_llama": off,
        "check_quant": {k: quant[k] for k in ("shape", "kernel_ms",
                                              "library_ms", "bound_ms")},
        "check_append_rel_err": append_err, "time_append": walk}


# -- phase 4: the server ------------------------------------------------------

def _post(url: str, body: dict, timeout: float = 600.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by name (each counts its
    launches in ``.launches``): the serving path's and kernel E's."""
    from p2p_llm_chat_tpu_torch import ops
    from p2p_llm_chat_tpu_torch.tools.mm_micro import w8a8_matmul
    return {**ops.wrappers(), "w8a8_matmul": w8a8_matmul}


def _get(url: str, timeout: float = 60.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _metrics(url: str) -> dict:
    text = _get(url + "/metrics")[1]
    return dict(line.rsplit(None, 1) for line in text.splitlines()
                if line.strip() and not line.startswith("#"))


def _on_loop(sched, fn):
    """Run ``fn`` on the scheduler thread between loop iterations (only
    that thread touches the decode state) and return its result."""
    return sched.run_on_loop(fn)


def _quiesce(sched) -> None:
    """Return once the loop has read back the pipelined tick a finished
    request leaves behind: a job runs at the start of a loop iteration,
    before that iteration's idle read-back, so the second of two jobs
    runs after it."""
    for _ in range(2):
        _on_loop(sched, lambda: None)


def _parked_replays(sched, body):
    """Run ``body(prog)`` on the scheduler thread, ``prog`` the graph
    ``decode_device_ms`` is probed on (K = 1 at the smallest window),
    with every row parked and the keys and mask restored afterwards, as
    the probe does; returns its result."""
    def run():
        prog = sched._decode_for(min(128, sched.max_seq))
        keys = sched._keys_dev.clone()
        act = sched._active_dev.clone()
        sched._active_dev.zero_()
        try:
            prog()
            return body(prog)
        finally:
            sched._keys_dev.copy_(keys)
            sched._active_dev.copy_(act)

    return _on_loop(sched, run)


def _probe_graph_ms(sched, n: int = 20) -> float:
    """CUDA-event ms per replay of the probed graph, ``n`` replays back
    to back."""
    import torch

    def body(prog) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            prog()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    return _parked_replays(sched, body)


def _graph_replay_ms(sched, key: tuple, n: int = 20) -> float:
    """CUDA-event ms per replay of the captured program under ``key``
    (``(window, K)`` or ``("spec", window)``), ``n`` replays
    back to back on the scheduler thread with every row parked (the
    probe's conditions; keys and mask restored)."""
    import torch

    def run() -> float:
        prog = sched._programs[key]
        keys = sched._keys_dev.clone()
        act = sched._active_dev.clone()
        sched._active_dev.zero_()
        try:
            prog()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                prog()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        finally:
            sched._keys_dev.copy_(keys)
            sched._active_dev.copy_(act)

    return _on_loop(sched, run)


def _wall_samples(sched) -> list:
    """The decode-wall histogram's samples so far (per step, ms)."""
    h = sched._wall_hist
    with h._mu:
        return list(h._samples)


def _p50(xs) -> float:
    return sorted(xs)[len(xs) // 2] if xs else float("nan")


def _burst(url: str, reqs) -> tuple[list, float]:
    """``reqs`` fired at once, one thread each: (answers, wall s)."""
    answers: list = [None] * len(reqs)

    def run(i: int) -> None:
        try:
            answers[i] = _post(url + reqs[i][0], reqs[i][1])
        except Exception as e:   # noqa: BLE001 — checked by the caller
            answers[i] = e

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers, time.monotonic() - t0


# The server phase's embed calls: (label, path, body).
EMBED_CALLS = (("R=2 S=256", "/api/embed", {"input": EMBED_SHORT}),
               ("R=8 S=2048", "/api/embed", {"input": EMBED_LONG}),
               ("R=16 S=256", "/api/embed", {"input": EMBED_WIDE}),
               ("legacy", "/api/embeddings", {"prompt": EMBED_SHORT[0]}))


def _embed_calls(url: str) -> tuple[list, list]:
    """The phase's embed calls (EMBED_CALLS): (vectors per call, wall ms
    per call)."""
    vecs, walls = [], []
    for _, path, body in EMBED_CALLS:
        t0 = time.monotonic()
        status, text = _post(url + path, body)
        walls.append((time.monotonic() - t0) * 1e3)
        check(status == 200, f"embed {path}: status {status}")
        rec = json.loads(text)
        vecs.append(rec["embeddings"] if path == "/api/embed"
                    else [rec["embedding"]])
    return vecs, walls


def _switch_loop_stream(sched, new):
    """Move the scheduler loop onto CUDA stream ``new``, ordered after
    the work of its current stream; returns that stream."""
    import torch

    def run():
        cur = torch.cuda.current_stream(sched.device)
        new.wait_stream(cur)
        torch.cuda.set_stream(new)
        return cur

    return _on_loop(sched, run)


def _burst_with_embeds(label: str, url: str, sched, reqs, idle) -> tuple:
    """The burst again while a second thread runs the embed calls: every
    request answered, the embeds at cosine >= 0.9999 to ``idle``.
    Returns (embed walls ms, burst s, decode p50 ms a step, min cosine)."""
    import torch
    base = len(_wall_samples(sched))
    during: dict = {}

    def fire() -> None:
        try:
            during["v"] = _embed_calls(url)
        except Exception as e:   # noqa: BLE001 — checked below
            during["v"] = e

    t = threading.Thread(target=fire)
    t.start()
    answers, burst_s = _burst(url, reqs)
    t.join()
    for (path, _), ans in zip(reqs, answers):
        check(not isinstance(ans, Exception) and ans[0] == 200,
              f"server {label}: {path} during the embeds: {ans!r}")
    check(not isinstance(during["v"], Exception),
          f"server {label}: concurrent embeds: {during['v']!r}")
    conc, conc_ms = during["v"]
    cos = min(_cosines(torch.tensor(a), torch.tensor(b)).min().item()
              for a, b in zip(idle, conc))
    check(cos >= 0.9999, f"server {label}: concurrent embeds at cosine "
          f"{cos:.6f} to the idle ones")
    return conc_ms, burst_s, _p50(_wall_samples(sched)[base:]), cos


def _replay_during_embed(label: str, url: str, sched) -> tuple:
    """CUDA-event ms of the probed graph's replays, each timed alone,
    while a second thread's R = 8, S = 2048 embed is in flight: they
    start 0.1 s after the embed call and go on until it has returned;
    at least two must run. Returns (mean ms, replays)."""
    import torch
    res: dict = {}
    ended = threading.Event()

    def fire() -> None:
        try:
            res["status"] = _post(url + "/api/embed",
                                  {"input": EMBED_LONG})[0]
        except Exception as e:   # noqa: BLE001 — checked below
            res["status"] = e
        ended.set()

    def body(prog) -> list:
        times = []
        while not ended.is_set():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prog()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    t = threading.Thread(target=fire)
    t.start()
    time.sleep(0.1)
    times = _parked_replays(sched, body)
    t.join()
    check(res["status"] == 200, f"server {label}: the embed beside the "
          f"replays: {res['status']!r}")
    check(len(times) >= 2, f"server {label}: {len(times)} replays inside "
          "the embed")
    return sum(times) / len(times), len(times)


def _greedy_during_embed(label: str, url: str, req, want: list) -> str:
    """Greedy reruns of ``req``, one after another, while a second thread's
    R = 8, S = 2048 embed is in flight: each must return ``want`` (the
    context of the idle reruns), and at least one must spend half its
    wall or more inside the embed call. Returns a summary."""
    path, body = req
    embed: dict = {}
    started = threading.Event()

    def fire() -> None:
        t0 = time.monotonic()
        started.set()
        try:
            embed["status"] = _post(url + "/api/embed",
                                    {"input": EMBED_LONG})[0]
        except Exception as e:   # noqa: BLE001 — checked below
            embed["status"] = e
        embed["span"] = (t0, time.monotonic())

    t = threading.Thread(target=fire)
    t.start()
    started.wait()
    runs = []
    while t.is_alive():
        t0 = time.monotonic()
        ctx = json.loads(_post(url + path, body)[1])["context"]
        runs.append((t0, time.monotonic(), ctx))
    t.join()
    check(embed["status"] == 200, f"server {label}: the embed beside the "
          f"greedy reruns: {embed['status']!r}")
    e0, e1 = embed["span"]
    inside = [max(0.0, min(b, e1) - max(a, e0)) / (b - a)
              for a, b, _ in runs]
    check(bool(runs) and max(inside) >= 0.5, f"server {label}: no greedy "
          f"rerun ran inside the embed (shares {inside})")
    for i, (_, _, ctx) in enumerate(runs):
        check(ctx == want, f"server {label}: greedy rerun {i} during an "
              "embed differs from the idle reruns")
    return (f"{len(runs)} greedy reruns during an R=8 S=2048 embed of "
            f"{(e1 - e0) * 1e3:.0f} ms (shares of each rerun's wall inside "
            f"it: {', '.join(f'{x:.2f}' for x in inside)}) equal to the idle "
            "reruns")


def _server_embed(results: dict, label: str, url: str, engine, reqs,
                  expect: tuple[str, ...], greedy_ctx: list) -> dict:
    """Embeds on the served model: idle (launch counters zeroed before
    and read after; the R = 2 call on kernel A or C, every chunk on
    kernel D), then greedy reruns during an embed (equal to
    ``greedy_ctx``), then, with the loop on its own stream and on one of
    the other end of the priority range: the probe's graph replayed
    during an embed (A B B A), and the same calls from a second thread
    during a rerun of the burst (A B). Vectors of the hidden size, unit
    norm within 1e-3, the concurrent ones at cosine >= 0.9999 to the
    idle ones, the greedy rerun after the bursts equal to
    ``greedy_ctx``; prints the embed walls and replay times, and returns
    the bursts' decode p50 by the loop stream's priority."""
    import torch
    sched = engine.scheduler
    H = engine.config.hidden_size
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    idle, idle_ms = _embed_calls(url)
    launches = {n: f.launches for n, f in wrappers.items() if f.launches}
    for name in expect:
        if name not in ("paged_attention_append", "paged_attention",
                        "dense_attention"):
            check(launches.get(name, 0) > 0, f"server {label}: the idle "
                  f"embeds never launched {name} ({launches})")
    chunks = len(EMBED_CALLS)            # one chunk a call
    check(launches.get("prefill_attention")
          == chunks * engine.config.num_layers,
          f"server {label}: the embeds launched kernel D "
          f"{launches.get('prefill_attention')} times")
    for name, n in launches.items():
        rec = results.get(name)
        if rec is None:             # its kernel phase did not run
            continue
        rec.setdefault("launches_by_path", {})[f"{label} embed"] = n
        rec["launches"] = rec.get("launches", 0) + n
    for call in idle:
        for v in call:
            norm = math.sqrt(sum(x * x for x in v))
            check(len(v) == H and abs(norm - 1.0) <= 1e-3,
                  f"server {label}: embedding of dim {len(v)} (want {H}), "
                  f"norm {norm:.6f}")
    during = _greedy_during_embed(label, url, reqs[0], greedy_ctx)
    # The loop on its own stream (A) and on one of the other end of the
    # priority range (B): the probed graph replayed during an embed in the
    # order A B B A, the burst with embeds under A then B.
    own = _on_loop(sched, lambda: torch.cuda.current_stream(sched.device))
    alt = torch.cuda.Stream(sched.device,
                            priority=-100 if own.priority == 0 else 0)
    replays: dict = {}
    bursts: dict = {}
    try:
        for i, stream in enumerate((own, alt, alt, own)):
            _switch_loop_stream(sched, stream)
            replays.setdefault(stream.priority, []).append(
                _replay_during_embed(label, url, sched))
            if i < 2:
                bursts[stream.priority] = _burst_with_embeds(
                    label, url, sched, reqs, idle)
    finally:
        _switch_loop_stream(sched, own)
    stall = _metrics(url)["decode_stall_ms"]
    ctx = json.loads(_post(url + reqs[0][0], reqs[0][1])[1])["context"]
    check(ctx == greedy_ctx, f"server {label}: the greedy rerun after the "
          "concurrent embeds differs")
    print(f"server {label}: {during}", flush=True)
    print(f"server {label}: embed walls ms idle: " + ", ".join(
        f"{name} {ms:.1f}" for (name, _, _), ms in zip(EMBED_CALLS, idle_ms))
        + f"; dim {H}; decode_stall_ms (the server's max) {stall}; embed "
        f"launches {launches}", flush=True)
    for prio, rs in replays.items():
        walls, burst_s, p50, cos = bursts[prio]
        print(f"server {label}: loop stream at priority {prio} (the port's "
              f"{'own' if prio == own.priority else 'alternative'}): the "
              "probed K=1 graph during an R=8 S=2048 embed "
              + " / ".join(f"{ms:.3f} ms (mean of {n})" for ms, n in rs)
              + f" a replay; burst with embeds {burst_s:.2f} s, decode p50 "
              f"{p50:.3f} ms a step, embed walls ms during it: "
              + ", ".join(f"{name} {ms:.1f}" for (name, _, _), ms in
                          zip(EMBED_CALLS, walls))
              + f"; concurrent vs idle cosine min {cos:.7f}", flush=True)
    return {prio: b[2] for prio, b in bursts.items()}


def _server_recovery(label: str, url: str, sched, req) -> None:
    """For ``serve.scheduler.dispatch`` and then ``serve.engine.readback``
    armed ``raise*1``: a streamed request ends in a well-formed error
    record, /metrics counts one hit of the site, and the greedy rerun
    after it equals ``req``'s greedy context from before. Each site is
    armed on a quiet loop, so it fires on the streamed request's ticks,
    not on the last tick of the request before."""
    from p2p_llm_chat_tpu_torch.utils import failpoints as fp
    path, body = req
    want = json.loads(_post(url + path, body)[1])["context"]
    for site in ("serve.scheduler.dispatch", "serve.engine.readback"):
        _quiesce(sched)
        fp.reset_hits()
        fp.arm(site, "raise*1")
        try:
            status, text = _post(url + "/api/generate", {
                "prompt": "fault me", "stream": True,
                "options": {"num_predict": 16}})
        finally:
            fp.disarm(site)
        lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        last = lines[-1] if lines else {}
        check(status == 200 and last.get("done") is True
              and "error" in last, f"server {label}: {site}: stream ended "
              f"with {last}")
        hits = _metrics(url).get(f'failpoint_hits_total{{site="{site}"}}')
        check(hits == "1", f"server {label}: {site}: failpoint_hits_total "
              f"{hits}")
        got = json.loads(_post(url + path, body)[1])["context"]
        check(got == want, f"server {label}: the greedy rerun after the "
              f"{site} fault differs")
        print(f"server {label}: {site}=raise*1: stream ended with "
              f"{last['error']!r}, failpoint_hits_total {hits}, greedy "
              "rerun identical", flush=True)


def _server_trace(label: str, url: str) -> None:
    """A request pinned to a trace id is held by /admin/trace with the
    front's and the scheduler's spans; /admin/trace/dump writes a file."""
    tid = os.urandom(16).hex()
    req = urllib.request.Request(
        url + "/api/generate", data=json.dumps({
            "prompt": "trace me", "stream": False,
            "options": {"num_predict": 8}}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Graft-Trace": f"{tid};s=1"})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"server {label}: traced request {r.status}")
    spans = json.loads(_get(f"{url}/admin/trace?id={tid}")[1])["spans"]
    names = {sp["name"] for sp in spans}
    want = {"api.request", "sched.queue_wait", "sched.prefill",
            "sched.decode"}
    check(want <= names, f"server {label}: trace holds {sorted(names)}")
    status, text = _post(url + "/admin/trace/dump", {})
    path = json.loads(text)["path"]
    check(status == 200 and os.path.exists(path), f"server {label}: "
          f"/admin/trace/dump answered {status} {text}")
    print(f"server {label}: trace {tid} holds "
          + ", ".join(f"{sp['name']} {sp['dur_ms']:.1f} ms" for sp in spans)
          + f"; flight dump at {path}", flush=True)


# The server phases' burst: 7 requests at once, one of them 1,500 bytes
# long and one the co-pilot's (the prefix path); ``chat`` is the chat
# request's user message.
LONG_PROMPT = ("The co-pilot reads the whole conversation before it drafts "
               "a reply. " * 40)[:1500]


def _server_reqs(chat: str = "how are you?") -> list:
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    return [
        ("/api/generate", {"prompt": "Draft a reply to: see you at noon?",
                           "stream": False, "options": {"num_predict": 24}}),
        ("/api/generate", {"prompt": "hello there", "stream": True,
                           "options": {"num_predict": 24, "temperature": 0.8,
                                       "seed": 11, "top_k": 40,
                                       "top_p": 0.9}}),
        ("/api/chat", {"messages": [{"role": "user", "content": chat}],
                       "stream": False, "options": {"num_predict": 16}}),
        ("/api/generate", {"prompt": LONG_PROMPT, "stream": False,
                           "options": {"num_predict": 16}}),
        ("/api/generate", {"prompt": "stream me", "stream": True,
                           "options": {"num_predict": 32}}),
        ("/api/generate", {"prompt": "penalised", "stream": False,
                           "options": {"num_predict": 20,
                                       "repeat_penalty": 1.1}}),
        ("/api/generate", {"prompt": SUGGEST_PREFIX + "are we still on for "
                           "lunch tomorrow?", "stream": False,
                           "options": {"num_predict": 24}}),
    ]


def _check_burst(label: str, reqs, answers) -> list:
    """Every answer of a burst 200 with a well-formed final record (a
    well-formed stream, 0 < eval_count <= num_predict, a generate's
    context as long as its prompt and answer); the final records."""
    finals = []
    for (path, body), ans in zip(reqs, answers):
        check(not isinstance(ans, Exception), f"{label} {path}: {ans!r}")
        status, text = ans
        check(status == 200, f"{label} {path}: status {status}")
        lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        check(len(lines) >= 1, f"{label} {path}: empty body")
        rec = lines[-1]
        check(rec.get("done") is True and "error" not in rec,
              f"{label} {path}: bad final record {rec}")
        if body.get("stream"):
            check(all(x.get("done") is False for x in lines[:-1]),
                  f"{label} {path}: malformed stream")
        n_pred = body["options"]["num_predict"]
        check(0 < rec["eval_count"] <= n_pred,
              f"{label} {path}: eval_count {rec['eval_count']} not in "
              f"(0, {n_pred}]")
        if path == "/api/generate":
            check(len(rec["context"]) == rec["prompt_eval_count"]
                  + rec["eval_count"], f"{label} {path}: context length")
        finals.append(rec)
    return finals


def phase_server(results: dict, model: str, quant: str,
                 expect: tuple[str, ...], prefill_chunk: int = 256,
                 impl: str = "gather", kv: str = "paged",
                 capture: bool = False, copilot: bool = False) -> None:
    """The engine for ``model`` at ``quant`` weights (32 layers, paged KV
    — int8 under the default attend-then-write ``impl``, bf16 under a
    write-then-attend one — or, with ``kv="dense"``, the bf16 dense cache
    (A8's decode mode, no page tables), 8 slots, max_seq 4096, the prefix
    cache on
    with the co-pilot template registered, chunked prefill at
    ``prefill_chunk``; 0 admits every prompt in one piece) behind the
    Ollama front answers the 7-request burst and two greedy reruns; every
    kernel's launch counter is zeroed just before the burst and read just
    after the reruns, each kernel in ``expect`` must have been launched
    and the other branch's attention kernel never (on the dense cache,
    neither of kernel B's paged decode modes). The co-pilot request
    must take the prefix path, and with chunking on the long prompt must
    admit in chunks. With ``capture``, the engine serves
    ``SERVE_PROFILE_PORT`` and, after the readings, a third greedy rerun
    runs under a 2 s capture of the loop (:func:`_server_capture`). With
    ``copilot``, the chat plane's co-pilot leg runs last, after every
    check above has run on the random weights (:func:`_copilot_leg`)."""
    import torch
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env

    wta = impl != "gather"
    dense = kv == "dense"
    kv_dtype = "bf16" if wta or dense else "int8"
    label = (f"{model} {quant}" + ("" if prefill_chunk else " chunk=0")
             + (f" {kv_dtype} KV impl={impl}" if wta else "")
             + (" dense KV" if dense else ""))
    os.environ.update(SERVE_BACKEND="torch", MODEL_CONFIG=model,
                      SERVE_KV=kv, SERVE_QUANT=quant,
                      SERVE_KV_QUANT="" if wta or dense else "int8",
                      SERVE_SLOTS="8",
                      SERVE_MAX_SEQ="4096", SERVE_DEVICE="cuda",
                      SERVE_PREFILL_CHUNK=str(prefill_chunk),
                      SERVE_PREFIX="1", PAGED_ATTN_IMPL=impl,
                      SERVE_PROFILE_PORT=str(_free_port()) if capture
                      else "0")
    print(f"server {label}: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "allocated before the build", flush=True)
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
        check(engine.scheduler.attn_impl == impl, f"server {label}: the "
              f"engine serves impl {engine.scheduler.attn_impl!r}")
        print(f"server {label}: {engine.config.num_layers} layers, "
              f"{kv_dtype} {kv} KV, 8 slots, "
              f"max_seq 4096, ready in "
              f"{time.monotonic() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        url = server.url
        sched = engine.scheduler
        m = _metrics(url)
        probe = float(m["decode_device_ms"])
        event_ms = _probe_graph_ms(sched)
        print(f"server {label}: decode_device_ms {probe:.4f} (warmup probe, "
              f"K=1 graph at W={min(128, sched.max_seq)}, every row parked) "
              f"vs {event_ms:.4f} ms a replay by CUDA events over 20 "
              f"replays ({probe / event_ms - 1:+.1%}); after warmup "
              f"loop_stall_ms {m['loop_stall_ms']}, loop_stall_last_ms "
              f"{m['loop_stall_last_ms']}, serve_flight_dumps_total "
              f"{m['serve_flight_dumps_total']}", flush=True)
        check(probe > 0 and abs(probe - event_ms) <= 0.15 * event_ms,
              f"server {label}: decode_device_ms {probe} vs {event_ms:.4f} "
              "ms by events")
        reqs = _server_reqs()
        wrappers = _wrappers()
        base = len(_wall_samples(sched))
        for fn in wrappers.values():
            fn.launches = 0
        answers, burst_s = _burst(url, reqs)
        burst_p50 = _p50(_wall_samples(sched)[base:])
        finals = _check_burst(f"server {label}", reqs, answers)
        # Determinism: the same greedy request twice, alone, gives the
        # same context ids.
        recs = [json.loads(_post(url + reqs[0][0], reqs[0][1])[1])
                for _ in range(2)]
        ctx = [r["context"] for r in recs]
        check(ctx[0] == ctx[1], f"server {label}: greedy reruns differ")
        launches = {name: fn.launches for name, fn in wrappers.items()}
        print(f"server {label}: {len(reqs)} concurrent requests answered in "
              f"{burst_s:.2f} s, greedy rerun identical ({len(ctx[0])} "
              f"context ids); kernel launches on this path: {launches}")
        for name in expect:
            check(launches[name] > 0, f"server {label}: kernel {name} was "
                  "never launched")
        others = (("paged_attention_append", "paged_attention") if dense
                  else ("paged_attention_append",) if wta
                  else ("paged_attention",))
        for other in others:
            check(launches[other] == 0, f"server {label}: {other} was "
                  f"launched {launches[other]} times on the "
                  f"{kv if dense else impl} branch")
        snap = engine.metrics_snapshot()
        print(f"server {label}: prefill_chunks_total "
              f"{snap['prefill_chunks_total']}, serve_prefix_admits_total "
              f"{snap['serve_prefix_admits_total']}, serve_prefix_entries "
              f"{snap['serve_prefix_entries']}")
        check(snap["serve_prefix_admits_total"] > 0, f"server {label}: the "
              "co-pilot request did not take the prefix path")
        check((snap["prefill_chunks_total"] > 0) == (prefill_chunk > 0),
              f"server {label}: prefill_chunks_total "
              f"{snap['prefill_chunks_total']} at SERVE_PREFILL_CHUNK="
              f"{prefill_chunk}")
        _record_launches(results, label, launches)
        ttfts = [r["prompt_eval_duration"] / 1e6 for r in finals]
        print(f"server {label}: TTFT ms by request: long prompt "
              f"({finals[3]['prompt_eval_count']} tokens) {ttfts[3]:.1f}, "
              f"co-pilot ({finals[6]['prompt_eval_count']} tokens) "
              f"{ttfts[6]:.1f}, others "
              f"{', '.join(f'{t:.1f}' for i, t in enumerate(ttfts) if i not in (3, 6))}")
        ttft = sorted(ttfts)
        toks = sum(r["eval_count"] for r in finals)
        per_req = [r["eval_count"] / (r["eval_duration"] / 1e9)
                   for r in finals if r["eval_duration"] > 0]
        metrics = _metrics(url)
        fused = {k: float(metrics.get(k, 0)) for k in (
            "decode_fused_ticks_total", "decode_fused_steps_total",
            "decode_fused_mean_k", "decode_wall_ms", "decode_stall_ms",
            "serve_decode_ticks_total")}
        check(fused["decode_fused_ticks_total"] > 0
              and fused["decode_fused_mean_k"] > 1, f"server {label}: "
              f"decode did not fuse ({fused})")
        print(f"server {label}: TTFT p50 {ttft[len(ttft) // 2]:.1f} ms (max "
              f"{ttft[-1]:.1f} ms) over {len(reqs)} requests; decode {toks} "
              f"tokens in "
              f"{burst_s:.2f} s = {toks / burst_s:.1f} tok/s aggregate, "
              f"{sorted(per_req)[len(per_req) // 2]:.1f} tok/s per request "
              f"(p50); decode_wall_ms (p50 per step) "
              f"{fused['decode_wall_ms']:.3f} at B=8; "
              f"{fused['serve_decode_ticks_total']:.0f} ticks, "
              f"{fused['decode_fused_ticks_total']:.0f} fused, mean K "
              f"{fused['decode_fused_mean_k']:.3f}, decode_stall_ms "
              f"{fused['decode_stall_ms']:.3f}; "
              f"{len(engine.scheduler._programs)} decode graphs")
        if capture:
            # After the readings above, so that they stay comparable: a
            # third greedy rerun under a capture of the loop.
            rec, cap = _server_capture(label, engine, url, reqs)
            check(rec["context"] == ctx[0], f"server {label}: the greedy "
                  "rerun under the capture differs")
            cost = [r["eval_duration"] / 1e6 / r["eval_count"]
                    for r in (recs[1], rec)]
            print(f"server {label}: the greedy rerun's decode {cost[0]:.3f} "
                  f"ms a token, {cost[1]:.3f} under the capture "
                  f"({cost[1] / cost[0] - 1:+.1%}) [card: {card_line()}]",
                  flush=True)
            results.setdefault("_profile_capture", {})[label] = dict(
                cap, rerun_token_ms=round(cost[0], 4),
                rerun_token_ms_captured=round(cost[1], 4))
        conc = _server_embed(results, label, url, engine, reqs, expect,
                             ctx[0])
        print(f"server {label}: the burst's decode p50 {burst_p50:.3f} ms a "
              "step without embeds; with concurrent embeds, by the loop "
              "stream's priority: " + ", ".join(
                  f"{prio} {p50:.3f} ({p50 / burst_p50 - 1:+.1%})"
                  for prio, p50 in conc.items()), flush=True)
        _server_recovery(label, url, sched, reqs[0])
        _server_trace(label, url)
        if copilot:
            _copilot_leg(results, label, url, engine, model, quant)
    finally:
        server.stop()
        engine.stop()
        os.environ.pop("SERVE_PROFILE_PORT", None)


COPILOT_MESSAGE = "are we still on for lunch tomorrow? I can book the usual."
COPILOT_LEG_S = 20.0     # the leg's wall-time limit
# The leg's environment: no gateway probes; circuits spliced by the relay
# (a punch would bypass it); no re-register that would put B's direct
# address back into the directory; 32-token suggestions.
COPILOT_ENV = {"NATPMP": "0", "P2P_HOLEPUNCH": "0", "NODE_REREGISTER_S": "0",
               "UI_SUGGEST_PREDICT": "32"}


def _timed_post(url: str, body: dict, tid: str) -> tuple[float, dict]:
    """POST ``body`` pinned to trace ``tid``: the wall ms and the reply."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-Graft-Trace": f"{tid};s=1"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=120) as r:
        status, text = r.status, r.read()
    ms = (time.monotonic() - t0) * 1e3
    check(status == 200, f"co-pilot: {url} answered {status}")
    return ms, json.loads(text)


def _span_ms(url: str, tid: str, name: str) -> float:
    """The duration of span ``name`` of trace ``tid`` on ``url``'s store."""
    spans = json.loads(_get(f"{url}/admin/trace?id={tid}")[1])["spans"]
    got = [sp["dur_ms"] for sp in spans if sp["name"] == name]
    check(len(got) == 1, f"co-pilot: trace {tid} on {url} holds {spans}")
    return got[0]


def _timed_stream(url: str, body: dict) -> tuple[float, list]:
    """POST ``body`` and read the NDJSON reply line by line: the ms to its
    first line and the parsed lines."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first, lines = None, []
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"co-pilot: {url} answered {r.status}")
        for raw in r:
            if first is None:
                first = (time.monotonic() - t0) * 1e3
            if raw.strip():
                lines.append(json.loads(raw))
    check(first is not None and lines, f"co-pilot: {url} streamed nothing")
    return first, lines


def _send_to_inbox(label: str, ui_from: str, node_from: str, ui_to: str,
                   to_user: str, content: str) -> tuple[float, float, str]:
    """POST ``content`` to ``to_user`` through ``ui_from``'s node proxy and
    poll ``ui_to``'s inbox (every 2 ms) until it holds it: the ms from the
    send to the poll that saw it, the sending node's ``node.send`` span
    (lookup and delivery, the receiver's ack included) and its leg."""
    t0 = time.monotonic()
    status, sent = _post(f"{ui_from}/node/send",
                         {"to_username": to_user, "content": content},
                         timeout=30)
    sent = json.loads(sent)
    check(status == 200 and sent["status"] == "sent",
          f"co-pilot {label}: /node/send answered {status} {sent}")
    deadline = t0 + 10
    while True:
        inbox = json.loads(_get(f"{ui_to}/node/inbox?after=", timeout=10)[1])
        got = [m["content"] for m in inbox]
        if content in got:
            check(got.count(content) == 1, f"co-pilot {label}: the inbox "
                  f"holds the message {got.count(content)} times")
            ms = (time.monotonic() - t0) * 1e3
            break
        check(time.monotonic() < deadline, f"co-pilot {label}: the message "
              f"never reached the inbox (holds {got})")
        time.sleep(0.002)
    spans = json.loads(_get(f"{node_from}/admin/trace?id="
                            f"{sent['trace']}")[1])["spans"]
    check(len(spans) == 1, f"co-pilot {label}: node.send spans {spans}")
    return ms, spans[0]["dur_ms"], spans[0]["meta"]["via"]


def _copilot_weights(label: str, engine, model: str, quant: str) -> float:
    """Copy full-width quote weights (models/synth.quote_params, the same
    tree shapes) into the running engine's tensors on its loop, then drop
    every cached prefix (its KV came from the random weights) and build
    the co-pilot prefix anew. Random weights' greedy ids mostly decode to
    nothing, so the suggestion would be empty; the phase's own checks ran
    on the random weights before this. Returns the seconds it took."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    t0 = time.monotonic()
    sched = engine.scheduler
    new = sched._family.fuse_params(quote_params(
        get_config(model), seed=0, quant=quant, device="cuda"))
    n = [0]

    def copy(dst, src, path: str) -> None:
        if isinstance(dst, dict):
            check(isinstance(src, dict) and set(dst) == set(src),
                  f"co-pilot {label}: quote tree keys at {path or '/'}")
            for k in dst:
                copy(dst[k], src[k], f"{path}/{k}")
        elif isinstance(dst, tuple):
            check(type(src) is type(dst) and len(src) == len(dst),
                  f"co-pilot {label}: quote leaf {path}")
            for i, (d, x) in enumerate(zip(dst, src)):
                copy(d, x, f"{path}.{i}")
        else:
            check(torch.is_tensor(dst) and torch.is_tensor(src)
                  and dst.shape == src.shape and dst.dtype == src.dtype,
                  f"co-pilot {label}: quote leaf {path}")
            dst.copy_(src)
            n[0] += 1

    def swap() -> int:
        copy(sched._params, new, "")
        torch.cuda.synchronize()
        store = sched._prefix
        with store._lock:
            store._entries.clear()
            store._seen.clear()
        sched._promote_q.clear()
        return sched.register_prefix(SUGGEST_PREFIX)

    P = sched.run_on_loop(swap)
    del new
    torch.cuda.empty_cache()
    check(P > 0 and sched._prefix.lengths() == [P], f"co-pilot {label}: "
          f"the prefix store holds {sched._prefix.lengths()} after the "
          f"swap (the co-pilot prefix is {P} tokens)")
    secs = time.monotonic() - t0
    print(f"server {label} co-pilot: {n[0]} tensors now hold quote weights, "
          f"the co-pilot prefix ({P} tokens) rebuilt, in {secs:.2f} s",
          flush=True)
    return secs


def _copilot_leg(results: dict, label: str, url: str, engine, model: str,
                 quant: str) -> None:
    """The chat plane in front of the running server, in this process,
    once the server holds quote weights (:func:`_copilot_weights`):
    the port's directory, relay and two nodes (NATPMP=0; A reachable
    directly, B advertising only its /p2p-circuit/ address through the
    relay, P2P_HOLEPUNCH=0 so the circuit is spliced by the relay) and a
    UI for each (UI_SUGGEST_PREDICT=32, ``ollama_url`` the server). With
    the launch counters zeroed: a message A -> B through the circuit; B's
    ``/api/suggest`` equal to ``response.strip()`` of a direct greedy
    ``/api/generate`` of the same payload, and ``/api/suggest/stream``'s
    deltas concatenating to that response; B accepts (``/node/send`` to
    A) and A's inbox holds exactly the suggestion. Kernels A, B (append
    mode) and D must have launched and ``serve_prefix_admits_total`` risen
    by at least 2; the leg must take COPILOT_LEG_S or less."""
    import importlib.util
    t_leg = time.monotonic()
    crypto = "cryptography"
    if importlib.util.find_spec("cryptography") is None:
        os.environ["P2P_DEV_CRYPTO"] = "1"
        crypto = "dev stand-ins (P2P_DEV_CRYPTO=1)"
    saved = {k: os.environ.get(k) for k in COPILOT_ENV}
    os.environ.update(COPILOT_ENV)
    from p2p_llm_chat_tpu_torch.directory import DirectoryService
    from p2p_llm_chat_tpu_torch.node import ChatNode
    from p2p_llm_chat_tpu_torch.relay import RelayService
    from p2p_llm_chat_tpu_torch.ui import SUGGEST_TEMPLATE, ChatUI
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    check(SUGGEST_TEMPLATE.startswith(SUGGEST_PREFIX), "co-pilot: the UI's "
          "template does not start with the prefix the engine registers")
    from p2p_llm_chat_tpu_torch.utils import native
    started = []
    try:
        swap_s = _copilot_weights(label, engine, model, quant)
        native.load("net_splice")    # the relay's pump, built in set-up
        relay = RelayService(addr="127.0.0.1:0").start()
        started.append(relay)
        directory = DirectoryService(addr="127.0.0.1:0").start()
        started.append(directory)
        a = ChatNode(username="najy", http_addr="127.0.0.1:0",
                     directory_url=directory.url, bootstrap_addrs="",
                     relay_addrs="", identity_file="", dht_addr="off").start()
        started.append(a)
        b = ChatNode(username="cannan", http_addr="127.0.0.1:0",
                     directory_url=directory.url, bootstrap_addrs="",
                     relay_addrs=str(relay.addr()), identity_file="",
                     dht_addr="off").start()
        started.append(b)
        rec = a.dir.lookup("cannan")
        circuit = [x for x in rec.addrs if "/p2p-circuit/" in x]
        check(len(circuit) == 1, f"co-pilot: B registered {rec.addrs}")
        a.dir.register("cannan", rec.peer_id, circuit)
        ui_a = ChatUI(node_http=a.http_url, ollama_url=url,
                      addr="127.0.0.1:0").start()
        started.append(ui_a)
        ui_b = ChatUI(node_http=b.http_url, ollama_url=url,
                      addr="127.0.0.1:0").start()
        started.append(ui_b)
        check(ui_b.suggest_predict == 32, "co-pilot: UI_SUGGEST_PREDICT")
        deadline = time.monotonic() + 5
        while b.host.peer_id not in relay._reservations:
            check(time.monotonic() < deadline, "co-pilot: B holds no "
                  "reservation on the relay")
            time.sleep(0.01)
        set_up_s = time.monotonic() - t_leg

        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        admits0 = engine.metrics_snapshot()["serve_prefix_admits_total"]
        spliced0 = relay._n_spliced
        # 1. A -> B over the relay circuit.
        a_to_b, a_span, a_via = _send_to_inbox(
            "A -> B", ui_a.url, a.http_url, ui_b.url, "cannan",
            COPILOT_MESSAGE)
        check(relay._n_spliced > spliced0 and a_via == "relay", "co-pilot: "
              f"A -> B did not go through the relay's circuit ({a_via})")
        # 2. B's suggestion against the direct call with the same payload
        # (greedy by the server's default), three of each, alternating;
        # each pinned to a trace, so the server's api.request span splits
        # its wall into the server's time and the hops'.
        payload = {"model": ui_b.llm_model,
                   "prompt": SUGGEST_TEMPLATE.format(msg=COPILOT_MESSAGE),
                   "stream": False, "options": {"num_predict": 32}}
        direct_ms, ui_ms, direct_srv, ui_srv = [], [], [], []
        for _ in range(3):
            tid = os.urandom(16).hex()
            ms, direct = _timed_post(url + "/api/generate", payload, tid)
            direct_ms.append(ms)
            direct_srv.append(_span_ms(url, tid, "api.request"))
            tid = os.urandom(16).hex()
            ms, sug = _timed_post(ui_b.url + "/api/suggest",
                                  {"content": COPILOT_MESSAGE}, tid)
            ui_ms.append(ms)
            ui_srv.append(_span_ms(url, tid, "api.request"))
            suggestion = sug["suggestion"]
            check(suggestion != "(LLM error)"
                  and not suggestion.startswith("(LLM unavailable"),
                  f"co-pilot: degraded suggestion {suggestion!r}")
            check(suggestion == direct["response"].strip(), "co-pilot: "
                  f"/api/suggest {suggestion!r} is not the direct "
                  f"response {direct['response']!r}")
        check(suggestion, "co-pilot: the suggestion is empty")
        # 3. The stream through the UI against the server's own.
        first_direct, lines = _timed_stream(
            url + "/api/generate", dict(payload, stream=True))
        check("".join(x.get("response", "") for x in lines)
              == direct["response"], "co-pilot: the direct stream differs")
        first_ui, deltas = _timed_stream(ui_b.url + "/api/suggest/stream",
                                         {"content": COPILOT_MESSAGE})
        check(deltas[-1].get("done") is True
              and not any(x.get("error") for x in deltas),
              f"co-pilot: the UI stream ended with {deltas[-1]}")
        check("".join(x["delta"] for x in deltas) == direct["response"],
              "co-pilot: /api/suggest/stream's deltas do not concatenate "
              "to the direct response")
        # 4. B accepts: the suggestion goes back to A.
        b_to_a, b_span, b_via = _send_to_inbox(
            "B -> A", ui_b.url, b.http_url, ui_a.url, "najy", suggestion)
        inbox_a = json.loads(_get(f"{ui_a.url}/node/inbox?after=")[1])
        check([m["content"] for m in inbox_a] == [suggestion],
              f"co-pilot: A's inbox holds {inbox_a}")
        # 5. The kernels and the prefix path.
        launches = {name: fn.launches for name, fn in wrappers.items()}
        for name in ("quant_matmul", "paged_attention_append",
                     "prefill_attention"):
            check(launches[name] > 0, f"co-pilot: kernel {name} was never "
                  "launched")
        admits = (engine.metrics_snapshot()["serve_prefix_admits_total"]
                  - admits0)
        check(admits >= 2, f"co-pilot: serve_prefix_admits_total rose by "
              f"{admits}")
        leg_s = time.monotonic() - t_leg
        check(leg_s <= COPILOT_LEG_S, f"co-pilot: the leg took {leg_s:.1f} "
              f"s (limit {COPILOT_LEG_S:.0f})")
        _record_launches(results, f"{label} co-pilot", launches)
        # The UI's hop: each call's wall less the server's api.request
        # span, the median of the UI's calls less the direct calls'.
        hop_ui = sorted(w - sp for w, sp in zip(ui_ms, ui_srv))
        hop_direct = sorted(w - sp for w, sp in zip(direct_ms, direct_srv))
        med = hop_ui[1] - hop_direct[1]
        readings = dict(
            crypto=crypto, relay_pump=relay.pump,
            suggest_ms=[round(x, 3) for x in ui_ms],
            direct_ms=[round(x, 3) for x in direct_ms],
            suggest_server_ms=ui_srv, direct_server_ms=direct_srv,
            ui_added_ms_p50=round(med, 3),
            hop_ui_ms=[round(x, 3) for x in hop_ui],
            hop_direct_ms=[round(x, 3) for x in hop_direct],
            first_delta_ui_ms=round(first_ui, 3),
            first_line_direct_ms=round(first_direct, 3),
            a_to_b_ms=round(a_to_b, 3), a_to_b_node_send_ms=a_span,
            a_to_b_via=a_via, b_to_a_ms=round(b_to_a, 3),
            b_to_a_node_send_ms=b_span, b_to_a_via=b_via,
            launches={k: v for k, v in launches.items() if v},
            prefix_admits=admits, swap_s=round(swap_s, 3),
            set_up_s=round(set_up_s, 3),
            leg_s=round(leg_s, 3), card=card_line())
        results["_copilot"] = readings
        print(f"server {label} co-pilot: crypto {crypto}; relay pump "
              f"{relay.pump}; /api/suggest {med:+.3f} ms over the direct "
              f"call (p50 of 3 of wall less the server's api.request span: "
              f"{hop_ui[1]:.3f} vs {hop_direct[1]:.3f}; walls p50 "
              f"{sorted(ui_ms)[1]:.3f} vs {sorted(direct_ms)[1]:.3f}); "
              f"first streamed delta through "
              f"the UI {first_ui:.3f} ms vs the server's first NDJSON line "
              f"{first_direct:.3f} ms; send -> inbox A -> B ({a_via}) "
              f"{a_to_b:.3f} ms (node.send {a_span:.3f}), B -> A ({b_via}) "
              f"{b_to_a:.3f} ms (node.send {b_span:.3f}); "
              f"serve_prefix_admits_total +{admits}; launches "
              f"{readings['launches']}; leg {leg_s:.2f} s (set-up "
              f"{set_up_s:.2f} s, the weight swap {swap_s:.2f} s of it) "
              f"[card: {readings['card']}]", flush=True)
        print(f"server {label} co-pilot: the suggestion {suggestion!r}",
              flush=True)
    finally:
        for svc in reversed(started):
            svc.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# The __global__ names of kernels A, B (its append mode's split launch)
# and D, as torch.profiler names their launches.
CAPTURE_KERNELS = {"A": "qmm_kernel", "B": "paged_split_kernel",
                   "D": "prefill_attn_kernel"}


def _server_capture(label: str, engine, url: str, reqs) -> tuple:
    """A 2 s capture through the engine's ``SERVE_PROFILE_PORT`` listener
    (obs/profile_server.py) while the greedy rerun, then a 401-token
    prompt (two chunks, two tokens), run: the trace must name kernels A,
    B (append) and D by their ``__global__`` names, the decode graphs'
    replays included, and the loop's ``sched.tick`` and ``sched.chunk``
    ranges.
    Returns the rerun's final record and the capture's readings (trace
    bytes, gzip and raw, events, kernel launches, ``sched.*`` ranges, the
    capture's wall, the loop's ms in starting and stopping it)."""
    import gzip
    prof_url = engine.profile_server.url
    got: dict = {}

    def take():
        t0 = time.monotonic()
        req = urllib.request.Request(
            prof_url + "/profile", method="POST",
            data=json.dumps({"duration_ms": 2000}).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                got["res"] = (r.status, r.read(),
                              float(r.headers["X-Profile-Loop-Ms"]))
        except Exception as e:   # noqa: BLE001 — reported by the check
            got["res"] = (None, repr(e).encode(), None)
        got["wall_s"] = time.monotonic() - t0
    t = threading.Thread(target=take)
    t.start()
    time.sleep(0.2)
    rec = json.loads(_post(url + reqs[0][0], reqs[0][1])[1])
    # A 401-token prompt: two chunks of 256, then two tokens of decode.
    long_status, _ = _post(url + "/api/generate", {
        "prompt": LONG_PROMPT[:400], "stream": False,
        "options": {"num_predict": 2}})
    t.join(120)
    check(not t.is_alive() and long_status == 200, f"server {label}: the "
          "capture or the chunked prompt under it did not finish")
    status, body, loop_ms = got["res"]
    check(status == 200, f"server {label}: POST /profile answered {status}: "
          f"{body[:200]!r}")
    raw = gzip.decompress(body)
    events = json.loads(raw)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ranges = {}
    for e in events:
        name = e.get("name", "")
        if name.startswith("sched."):
            ranges[name] = ranges.get(name, 0) + 1
    found = {k: sum(n in name for name in kernels)
             for k, n in CAPTURE_KERNELS.items()}
    check(all(found.values()) and ranges.get("sched.tick")
          and ranges.get("sched.chunk"), f"server {label}: the capture "
          f"names kernels {found} and ranges {ranges}")
    print(f"server {label}: a 2 s capture through SERVE_PROFILE_PORT during "
          f"the greedy rerun and a chunked prompt: {len(body)} bytes gzip "
          f"({len(raw)} raw), {len(events)} events, {len(kernels)} kernel "
          f"launches (A {found['A']}, B {found['B']}, D {found['D']} by "
          f"their __global__ names), ranges {ranges}; answered in "
          f"{got['wall_s']:.2f} s, the loop {loop_ms:.1f} ms in starting "
          "and stopping the profiler", flush=True)
    return rec, dict(gzip_bytes=len(body), raw_bytes=len(raw),
                     events=len(events), kernel_launches=len(kernels),
                     by_kernel=found, ranges=ranges,
                     wall_s=round(got["wall_s"], 3), loop_ms=loop_ms)


# The spec servers' burst: the chat burst's shapes with longer answers
# (the quote weights' output repeats a 16-token phrase, so n-gram drafts
# land from the second lap on); every request but the sampled one is
# greedy.
SPEC_CYCLE = "0123456789:;<=>?"


def _spec_reqs():
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    long_prompt = LONG_PROMPT
    gen = lambda p, n, **o: ("/api/generate", {
        "prompt": p, "stream": bool(o.pop("stream", False)),
        "options": dict(num_predict=n, **o)})
    return [
        gen("Draft a reply to: see you at noon?", 64),
        gen("hello there", 48, stream=True, temperature=0.8, seed=11,
            top_k=40, top_p=0.9),
        ("/api/chat", {"messages": [{"role": "user",
                                     "content": "how are you?"}],
                       "stream": False, "options": {"num_predict": 48}}),
        gen(long_prompt, 48),
        gen(SPEC_CYCLE * 2 + SPEC_CYCLE[:12], 64, stream=True),
        gen("penalised", 48, repeat_penalty=1.1),
        gen(SUGGEST_PREFIX + "are we still on for lunch tomorrow?", 64),
    ]


def _check_answers(label: str, reqs, answers) -> list:
    finals = []
    for (path, body), ans in zip(reqs, answers):
        check(not isinstance(ans, Exception), f"{label} {path}: {ans!r}")
        status, text = ans
        lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        rec = lines[-1] if lines else {}
        check(status == 200 and rec.get("done") is True
              and "error" not in rec, f"{label} {path}: {status} {rec}")
        n_pred = body["options"]["num_predict"]
        check(0 < rec["eval_count"] <= n_pred, f"{label} {path}: "
              f"eval_count {rec['eval_count']}")
        finals.append(rec)
    return finals


def _spec_burst(label: str, url: str, reqs) -> dict:
    """The burst once: answers checked; readings from the answers and
    the /metrics deltas (per-request decode rate from eval_count /
    eval_duration)."""
    m0 = _metrics(url)
    answers, wall = _burst(url, reqs)
    finals = _check_answers(label, reqs, answers)
    m1 = _metrics(url)
    d = lambda k: float(m1.get(k, 0)) - float(m0.get(k, 0))
    toks = sum(r["eval_count"] for r in finals)
    rates = sorted(r["eval_count"] / (r["eval_duration"] / 1e9)
                   for r in finals if r["eval_duration"] > 0)
    return dict(wall=wall, toks=toks, tok_s=toks / wall,
                p50_rate=rates[len(rates) // 2],
                accepted=d("serve_spec_accepted_total"),
                ticks=d("serve_decode_ticks_total"),
                per_dispatch=float(m1.get("serve_spec_accepted_per_dispatch",
                                          0)))


def _greedy_contexts(url: str, reqs) -> list:
    out = []
    for path, body in reqs:
        if body["options"].get("temperature", 0) > 0:
            continue
        body = dict(body, stream=False)
        rec = json.loads(_post(url + path, body)[1])
        out.append(rec.get("context") or rec["message"]["content"])
    return out


def phase_server_spec(results: dict, model: str, quant: str,
                      impl: str = "gather", nodes: int = 8) -> None:
    """The engine (32 layers, 8 slots, max_seq 4096, chunked admission
    and the prefix cache on) on full-width quote weights
    (models/synth.quote_params) with ``SERVE_SPEC=4`` and
    ``SERVE_SPEC_TREE_NODES=nodes`` (8 is the reference's default; 0
    linear), over an int8 pool (or a bf16 one under a write-then-attend
    ``impl``), behind the Ollama front. The spec burst with every
    counter zeroed: answers well formed, ``serve_spec_accepted_total`` >
    0 and ``serve_spec_accepted_per_dispatch`` > 1, kernel B's verify
    mode launched (on write-then-attend its pool mode, and the verify
    mode never). The greedy answers, rerun alone, equal the same
    server's with speculation off (``spec_k`` set to 0 between loop
    iterations, the burst rerun for readings). Then
    ``serve.scheduler.dispatch`` armed ``raise*1`` fires in a spec tick
    (the flight recorder's last ``spec`` event is the reset's
    iteration): the stream ends in an error record and the greedy rerun
    is unchanged. Prints served tok/s, per-request rate and inter-token
    p50, and accepted tokens per verify dispatch, spec on and off."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    from p2p_llm_chat_tpu_torch.utils import failpoints as fp

    wta = impl != "gather"
    label = (f"{model} {quant} spec K=4 "
             + (f"tree N={nodes}" if nodes else "linear")
             + (" bf16 KV impl=kernel" if wta else ""))
    os.environ.update(SERVE_BACKEND="torch", MODEL_CONFIG=model,
                      SERVE_KV="paged", SERVE_QUANT=quant,
                      SERVE_KV_QUANT="" if wta else "int8", SERVE_SLOTS="8",
                      SERVE_MAX_SEQ="4096", SERVE_DEVICE="cuda",
                      SERVE_PREFILL_CHUNK="256", SERVE_PREFIX="1",
                      PAGED_ATTN_IMPL=impl, SERVE_SPEC="4",
                      SERVE_SPEC_TREE_NODES=str(nodes))
    t0 = time.monotonic()
    engine = build_engine_from_env(params=quote_params(
        get_config(model), seed=0, quant=quant, device="cuda"))
    server = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        deadline = time.monotonic() + 600
        while not engine.ready():
            err = engine.warmup_error
            check(err is None, f"server {label}: warmup failed: {err!r}")
            check(time.monotonic() < deadline, f"server {label}: never "
                  "became ready")
            time.sleep(0.1)
        sched, url = engine.scheduler, server.url
        check(sched.spec_k == 4 and sched.spec_tree_nodes == nodes,
              f"server {label}: spec_k {sched.spec_k}, tree nodes "
              f"{sched.spec_tree_nodes}")
        spec_graphs = sum(1 for k in sched._programs if k[0] == "spec")
        print(f"server {label}: ready in {time.monotonic() - t0:.1f} s "
              f"(quote weights built included); "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; "
              f"{len(sched._programs)} graphs, {spec_graphs} of them spec "
              "programs", flush=True)
        reqs = _spec_reqs()
        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        on = _spec_burst(label, url, reqs)
        ctx_on = _greedy_contexts(url, reqs)
        launches = {n: f.launches for n, f in wrappers.items() if f.launches}
        m = _metrics(url)
        acc = float(m["serve_spec_accepted_total"])
        per = float(m["serve_spec_accepted_per_dispatch"])
        check(acc > 0 and per > 1, f"server {label}: "
              f"serve_spec_accepted_total {acc}, per dispatch {per}")
        verify = launches.get("paged_attention_verify_append", 0)
        if wta:
            check(verify == 0 and launches.get("paged_attention", 0) > 0,
                  f"server {label}: kernel B launches {launches}")
        else:
            check(verify > 0, f"server {label}: the verify mode was never "
                  f"launched ({launches})")
        for name, n in launches.items():
            rec = results.get(name)
            if rec is not None:
                rec.setdefault("launches_by_path", {})[label] = n
                rec["launches"] = rec.get("launches", 0) + n
        _on_loop(sched, lambda: setattr(sched, "spec_k", 0))
        try:
            off = _spec_burst(label + " spec off", url, reqs)
            ctx_off = _greedy_contexts(url, reqs)
        finally:
            _on_loop(sched, lambda: setattr(sched, "spec_k", 4))
        check(ctx_on == ctx_off, f"server {label}: greedy answers differ "
              "with speculation on and off")
        W = min(128, sched.max_seq)
        step_ms = _graph_replay_ms(sched, (W, 1))
        spec_ms = _graph_replay_ms(sched, ("spec", W))
        S = nodes or 5
        print(f"server {label}: one verify tick (S={S} positions, B=8, "
              f"graph replay, W={W}, rows parked) {spec_ms:.3f} ms against "
              f"a K=1 decode step {step_ms:.3f} ms: {spec_ms / step_ms:.2f} "
              "steps, so a tick gains where a drafted row accepts more "
              f"than {spec_ms / step_ms - 1:.2f} tokens", flush=True)
        print(f"server {label}: {len(ctx_on)} greedy answers equal with "
              f"speculation on and off; launches {launches}; "
              f"serve_spec_accepted_total {acc:.0f}, "
              f"serve_spec_accepted_per_dispatch {per}, "
              f"serve_spec_accept_ema {m['serve_spec_accept_ema']}"
              + (f", serve_spec_tree_accepted_path_len "
                 f"{m['serve_spec_tree_accepted_path_len']}" if nodes
                 else ""), flush=True)
        for name, r in (("on", on), ("off", off)):
            print(f"server {label}: spec {name}: {r['toks']} tokens in "
                  f"{r['wall']:.2f} s = {r['tok_s']:.1f} tok/s served, "
                  f"decode {r['p50_rate']:.1f} tok/s per request (p50), "
                  "decode ticks "
                  f"{r['ticks']:.0f}, accepted drafts {r['accepted']:.0f}"
                  + (f", accepted per verify dispatch {r['per_dispatch']}"
                     if name == "on" else ""), flush=True)
        # A fault in a spec tick: the first tick of a prompt that already
        # holds its continuation's bigram drafts at once.
        _quiesce(sched)
        fp.reset_hits()
        fp.arm("serve.scheduler.dispatch", "raise*1")
        try:
            status, text = _post(url + "/api/generate", {
                "prompt": SPEC_CYCLE * 2 + SPEC_CYCLE[:5], "stream": True,
                "options": {"num_predict": 16}})
        finally:
            fp.disarm("serve.scheduler.dispatch")
        lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        last = lines[-1] if lines else {}
        check(status == 200 and last.get("done") is True and "error" in last,
              f"server {label}: dispatch fault: stream ended with {last}")
        events = sched.flight_snapshot()
        resets = [e["it"] for e in events if e["kind"] == "reset"]
        specs = [e["it"] for e in events if e["kind"] == "spec"]
        check(resets and specs and specs[-1] == resets[-1],
              f"server {label}: the dispatch fault was not in a spec tick "
              f"(spec its {specs[-3:]}, resets {resets[-3:]})")
        again = _greedy_contexts(url, reqs[:1])
        check(again == ctx_on[:1], f"server {label}: the greedy rerun after "
              "the fault differs")
        print(f"server {label}: serve.scheduler.dispatch=raise*1 in a spec "
              f"tick: stream ended with {last['error']!r}; greedy rerun "
              "identical", flush=True)
    finally:
        server.stop()
        engine.stop()


def _record_launches(results: dict, label: str, launches: dict) -> None:
    for name, n in launches.items():
        rec = results.get(name)
        if rec is not None and n:
            rec.setdefault("launches_by_path", {})[label] = n
            rec["launches"] = rec.get("launches", 0) + n


def _serve_env(**kw) -> None:
    """The server phases' engine env (a later phase's settings never
    leak into the next one's build)."""
    for k in ("SERVE_SPEC", "SERVE_SPEC_TREE_NODES", "SERVE_DRAFT",
              "SERVE_KV_HOST_GB", "CKPT_DIR", "SERVE_MODELS",
              "SERVE_PROFILE_PORT"):
        os.environ.pop(k, None)
    os.environ.update(SERVE_BACKEND="torch", SERVE_SLOTS="8",
                      SERVE_MAX_SEQ="4096", SERVE_DEVICE="cuda",
                      SERVE_PREFILL_CHUNK="256", SERVE_PREFIX="1",
                      SERVE_KV_QUANT="", **kw)


def phase_server_dense(results: dict) -> None:
    """The dense KV path served (``SERVE_KV=dense``, the reference's
    default): llama3.1-8b int8 weights (32 layers, random, seed 0), a bf16
    dense cache of 8 rows x 4096, chunked admission at 256 and the prefix
    cache, behind the Ollama front. Counters zeroed before the 7-request
    burst and its greedy reruns: kernels A, D and A8's decode mode must
    launch, kernel B's append and verify modes (and its pool mode under
    its own name) must not; decode fuses (``decode_fused_mean_k`` > 1).
    Then the same weights served from a bf16 page pool under
    ``PAGED_ATTN_IMPL=kernel`` (kernel B's pool mode over the same
    values), the same burst: the greedy answers must be equal. Prints,
    for both in one call, the KV size, TTFT by request, decode p50 a
    step, the K = 1 graph's replay time and the warmup probe."""
    import torch
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    model, quant = "llama3.1-8b", "int8"
    cfg = get_config(model)
    params = family_for(cfg).init_params_quantized(cfg, seed=0, quant=quant,
                                                   device="cuda")
    reqs = _server_reqs()
    greedy: dict = {}
    for kv in ("dense", "paged"):
        label = f"{model} {quant} {kv} KV" + ("" if kv == "dense"
                                              else " impl=kernel")
        _serve_env(MODEL_CONFIG=model, SERVE_KV=kv, SERVE_QUANT=quant,
                   PAGED_ATTN_IMPL="kernel")
        t0 = time.monotonic()
        engine = build_engine_from_env(params=params)
        server = OllamaServer(engine, addr="127.0.0.1:0").start()
        try:
            ready_s = _wait_ready(f"server {label}", engine)
            sched, url = engine.scheduler, server.url
            check(sched.kv_mode == kv, f"server {label}: kv_mode "
                  f"{sched.kv_mode}")
            cache_gb = (sched._cache.nbytes() if kv == "dense" else
                        sched._cache.k.nbytes + sched._cache.v.nbytes) / 1e9
            print(f"server {label}: {cfg.num_layers} layers, bf16 {kv} "
                  f"KV {cache_gb:.3f} GB (8 x 4096), ready in "
                  f"{time.monotonic() - t0:.1f} s ({ready_s:.1f} s warmup); "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; "
                  f"{len(sched._programs)} decode graphs", flush=True)
            wrappers = _wrappers()
            base = len(_wall_samples(sched))
            for fn in wrappers.values():
                fn.launches = 0
            answers, burst_s = _burst(url, reqs)
            p50 = _p50(_wall_samples(sched)[base:])
            finals = _check_burst(f"server {label}", reqs, answers)
            greedy[kv] = _greedy_contexts(url, reqs)
            launches = {n: f.launches for n, f in wrappers.items()}
            print(f"server {label}: {len(reqs)} concurrent requests in "
                  f"{burst_s:.2f} s; launches {launches}", flush=True)
            if kv == "dense":
                for name in ("quant_matmul", "prefill_attention",
                             "dense_attention"):
                    check(launches[name] > 0, f"server {label}: {name} was "
                          "never launched")
                for name in ("paged_attention_append",
                             "paged_attention_verify_append",
                             "paged_attention", "dense_attention_verify"):
                    check(launches[name] == 0, f"server {label}: {name} was "
                          f"launched {launches[name]} times")
                _record_launches(results, "server_dense", launches)
            m = _metrics(url)
            mean_k = float(m["decode_fused_mean_k"])
            check(mean_k > 1, f"server {label}: decode_fused_mean_k "
                  f"{mean_k}")
            check(any(k.startswith("serve_kv_") for k in m) == (kv == "paged"),
                  f"server {label}: page-pool series on /metrics")
            W = min(128, sched.max_seq)
            k1 = _graph_replay_ms(sched, (W, 1))
            k1_1024 = _graph_replay_ms(sched, (1024, 1))
            by_req = [r["prompt_eval_duration"] / 1e6 for r in finals]
            print(f"server {label}: TTFT ms by request: long prompt "
                  f"({finals[3]['prompt_eval_count']} tokens) "
                  f"{by_req[3]:.1f}, co-pilot "
                  f"({finals[6]['prompt_eval_count']} tokens) "
                  f"{by_req[6]:.1f}, others " + ", ".join(
                      f"{t:.1f}" for i, t in enumerate(by_req)
                      if i not in (3, 6)), flush=True)
            ttft = sorted(by_req)
            toks = sum(r["eval_count"] for r in finals)
            print(f"server {label}: TTFT p50 {ttft[len(ttft) // 2]:.1f} ms "
                  f"(max {ttft[-1]:.1f}); decode {toks} tokens in "
                  f"{burst_s:.2f} s = {toks / burst_s:.1f} tok/s; decode p50 "
                  f"{p50:.3f} ms a step in the burst (decode_wall_ms "
                  f"{m['decode_wall_ms']}); decode_fused_mean_k {mean_k}; "
                  f"K=1 graph replay (rows parked) {k1:.3f} ms at W={W}, "
                  f"{k1_1024:.3f} ms at W=1024; decode_device_ms "
                  f"{m['decode_device_ms']}", flush=True)
            results.setdefault("_server_dense", {})[kv] = dict(
                cache_gb=round(cache_gb, 4), decode_p50_ms=round(p50, 4),
                decode_wall_ms=float(m["decode_wall_ms"]),
                long_prompt_ttft_ms=round(by_req[3], 2),
                ttft_p50_ms=round(ttft[len(ttft) // 2], 2),
                mean_k=mean_k, k1_graph_ms_w128=round(k1, 4),
                k1_graph_ms_w1024=round(k1_1024, 4))
        finally:
            server.stop()
            engine.stop()
            _free()
    check(greedy["dense"] == greedy["paged"], "server_dense: greedy answers "
          "differ between the dense cache and the bf16 pool (impl=kernel)")
    print(f"server_dense: {len(greedy['dense'])} greedy answers equal on the "
          "dense cache and the bf16 page pool (PAGED_ATTN_IMPL=kernel)",
          flush=True)


def _time_wide_dispatches(drafter) -> dict:
    """Wall ms of each of ``drafter``'s draft dispatches from now on (the
    instance's ``_dispatch_draft`` wrapped; ``del`` the attribute to
    unwrap), under "wide" where a row's pending block is wider than the
    graphed 16 positions (an eager feed through kernel B's verify mode
    at S > 16, catch-ups past 512 included), else "narrow"."""
    from p2p_llm_chat_tpu_torch.serve import draft_model as dm
    times = {"wide": [], "narrow": []}
    inner = drafter._dispatch_draft

    def timed(rows, ctxs):
        pend = max((dm._ctx_len(ctxs[r]) - drafter._fed[r] for r in rows),
                   default=0)
        t0 = time.monotonic()
        out = inner(rows, ctxs)
        if out[0]:
            times["wide" if pend > dm._GRAPH_MAX_FEED else "narrow"].append(
                (time.monotonic() - t0) * 1e3)
        return out
    drafter._dispatch_draft = timed
    return times


def phase_server_draft(results: dict) -> None:
    """The resident draft model on the dense path (``SERVE_KV=dense
    SERVE_SPEC=4``, tree default of 8 nodes): (a) llama3.1-8b int8 on
    full-width quote weights (models/synth.quote_params) with the drafter
    given the same weights in-process (``draft=(params, config)``): the
    spec burst with counters zeroed must accept from source ``model``
    (``serve_spec_accepted_per_dispatch{source="model"}`` > 1) through
    A8's verify mode, and the greedy answers equal the same server's with
    speculation off; (b) ``SERVE_DRAFT=draft-400m`` (random, seed 101) on
    the same target: its KV GB, ms per draft dispatch and acceptance
    printed."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import (TorchEngine,
                                                     build_engine_from_env)
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    model, quant = "llama3.1-8b", "int8"
    cfg = get_config(model)
    params = quote_params(cfg, seed=0, quant=quant, device="cuda")
    reqs = _spec_reqs()
    for case in ("self", "draft-400m"):
        label = f"{model} {quant} dense spec K=4 tree N=8 draft={case}"
        _serve_env(MODEL_CONFIG=model, SERVE_KV="dense", SERVE_QUANT=quant,
                   SERVE_SPEC="4", SERVE_SPEC_TREE_NODES="8")
        t0 = time.monotonic()
        if case == "self":
            engine = TorchEngine(
                params, cfg, ByteTokenizer(cfg.vocab_size), num_slots=8,
                max_seq=4096, kv_mode="dense", spec_k=4, spec_tree_nodes=8,
                prefill_chunk=256, draft=(params, cfg), device="cuda")
            engine.warmup((128, 256))
        else:
            os.environ["SERVE_DRAFT"] = case
            engine = build_engine_from_env(params=params)
        server = OllamaServer(engine, addr="127.0.0.1:0").start()
        try:
            ready_s = _wait_ready(f"server {label}", engine)
            sched, url = engine.scheduler, server.url
            d = engine.drafter
            check(d is not None and [x.name for x in sched._sources]
                  == ["ngram", "model"], f"server {label}: no drafter")
            n_graphs = sum(1 for k in sched._programs if k[0] == "draft")
            check(n_graphs > 0, f"server {label}: no drafter graph")
            print(f"server {label}: ready in {time.monotonic() - t0:.1f} s "
                  f"({ready_s:.1f} s warmup, {n_graphs} drafter graphs "
                  "captured); drafter KV "
                  f"{d.kv_bytes() / 1e9:.3f} GB, params "
                  f"{d.param_bytes() / 1e9:.3f} GB; "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
                  flush=True)
            wrappers = _wrappers()
            for fn in wrappers.values():
                fn.launches = 0
            n0, s0 = d.n_draft_dispatches, d.draft_s
            wide = _time_wide_dispatches(d)
            on = _spec_burst(label, url, reqs)
            ctx_on = _greedy_contexts(url, reqs)
            launches = {n: f.launches for n, f in wrappers.items()
                        if f.launches}
            m = _metrics(url)
            nd = d.n_draft_dispatches - n0
            ms_tick = (d.draft_s - s0) * 1e3 / max(1, nd)
            src = {k: m.get(f'{k}{{source="model"}}') for k in (
                "serve_spec_proposed_total", "serve_spec_accepted_total",
                "serve_spec_accept_rate",
                "serve_spec_accepted_per_dispatch")}
            ng = {k: m.get(f'{k}{{source="ngram"}}') for k in (
                "serve_spec_proposed_total", "serve_spec_accepted_total",
                "serve_spec_accepted_per_dispatch")}
            del d._dispatch_draft               # the class's method again
            wide_ms = sum(wide["wide"])
            all_ms = wide_ms + sum(wide["narrow"])
            print(f"server {label}: burst {on['toks']} tokens in "
                  f"{on['wall']:.2f} s = {on['tok_s']:.1f} tok/s served, "
                  f"{on['p50_rate']:.1f} tok/s per request (p50); drafter "
                  f"{nd} draft dispatches, {ms_tick:.2f} ms each (graph "
                  f"replays up to 16 pending tokens, readback included); "
                  f"{len(wide['wide'])} of them with a pending block "
                  f"wider than 16 (eager, kernel B's verify mode at "
                  f"S > 16): {wide_ms:.1f} of {all_ms:.1f} ms "
                  f"({wide_ms / max(all_ms, 1e-9):.0%}); "
                  f"source model {src}; source ngram "
                  f"{ng}; serve_spec_accepted_per_dispatch "
                  f"{m['serve_spec_accepted_per_dispatch']}, tree path len "
                  f"{m.get('serve_spec_tree_accepted_path_len')}; launches "
                  f"{launches}", flush=True)
            check(launches.get("dense_attention_verify", 0) > 0,
                  f"server {label}: A8's verify mode was never launched")
            check(not launches.get("paged_attention_verify_append")
                  and not launches.get("paged_attention_append"),
                  f"server {label}: kernel B's paged modes launched")
            _record_launches(results, f"server_draft {case}", launches)
            # One draft program replayed alone (the steady-state bucket of
            # 4 pending tokens at W = 128, the last dispatch's inputs
            # again: its writes repeat the same values) against the
            # dispatch wall above.
            replay_ms = _graph_replay_ms(sched, ("draft", 4, 128))
            lazy = sum(1 for k in sched._programs if k[0] == "draft")
            print(f"server {label}: a draft program's graph replay (M=4, "
                  f"W=128) {replay_ms:.3f} ms; {lazy - n_graphs} more "
                  "drafter graphs captured during the burst", flush=True)
            results.setdefault("_server_draft", {})[case] = dict(
                drafter_kv_gb=round(d.kv_bytes() / 1e9, 4),
                draft_ms_per_dispatch=round(ms_tick, 3),
                wide_dispatches=len(wide["wide"]),
                wide_dispatch_ms=round(wide_ms, 3),
                dispatch_ms=round(all_ms, 3),
                draft_graph_replay_ms=round(replay_ms, 4),
                model=src, ngram=ng, tok_s=round(on["tok_s"], 2),
                per_dispatch=m["serve_spec_accepted_per_dispatch"])
            if case != "self":
                continue
            check(float(src["serve_spec_accepted_per_dispatch"] or 0) > 1,
                  f"server {label}: model-source acceptance {src}")
            _on_loop(sched, lambda: setattr(sched, "spec_k", 0))
            try:
                off = _spec_burst(label + " spec off", url, reqs)
                ctx_off = _greedy_contexts(url, reqs)
            finally:
                _on_loop(sched, lambda: setattr(sched, "spec_k", 4))
            check(ctx_on == ctx_off, f"server {label}: greedy answers "
                  "differ with speculation on and off")
            print(f"server {label}: {len(ctx_on)} greedy answers equal with "
                  f"speculation on and off; spec off {off['toks']} tokens "
                  f"in {off['wall']:.2f} s = {off['tok_s']:.1f} tok/s "
                  f"served, {off['p50_rate']:.1f} tok/s per request (p50)",
                  flush=True)
        finally:
            server.stop()
            engine.stop()
            _free()


# The tier phase's conversation: a 1500-token first turn (the server
# phases' long prompt), then two short follow-up turns.
TIER_TURN2 = " And what would you add to that, in one short line?"
TIER_TURN3 = " Thanks. One more question before we finish?"


def _status(method: str, url: str, body=None, raw: bytes = None,
            timeout: float = 600.0) -> tuple:
    """(status, body bytes) of one request, error statuses included."""
    import urllib.error
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def _tier_gen(label: str, url: str, prompt: str, session: str, ctx=(),
              n: int = 24) -> dict:
    """One greedy /api/generate of a conversation turn; its final
    record."""
    body = {"prompt": prompt, "stream": False, "session": session,
            "options": {"num_predict": n}}
    if ctx:
        body["context"] = list(ctx)
    status, text = _status("POST", url + "/api/generate", body)
    check(status == 200, f"{label}: /api/generate {status} {text[:200]!r}")
    rec = json.loads(text)
    check(rec.get("done") is True and "error" not in rec,
          f"{label}: bad final record {rec}")
    return rec


def _first_diff(a: list, b: list) -> int:
    """Index of the first differing element (len of the shorter if one is
    a prefix of the other; -1 when equal)."""
    if a == b:
        return -1
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def _tier_copy_times(sched, key: str) -> dict:
    """On the scheduler thread, for the resident session ``key``: the park
    copy's parts timed apart, without parking it — the gather of its pages
    (padded to a power of two with page 0, CUDA events), the readback into
    pinned host memory as the scheduler parks (host clock; a synchronous
    copy), the upload of that payload as a wake does (host clock to the
    end of the copy) and its scatter (events; into page 0 only, the
    garbage page, so no live page changes); and, for comparison in the
    same call, a readback into pageable memory and the upload from it."""
    import torch
    from p2p_llm_chat_tpu_torch.ops.paged_kv import (gather_pages,
                                                     scatter_pages)

    def run():
        sess = next(x for x in sched._tier.resident_sessions()
                    if x.key == key)
        n = len(sess.pages)
        P2 = 1 << max(0, n - 1).bit_length()
        padded = torch.tensor(sess.pages + [0] * (P2 - n), dtype=torch.long)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        out = gather_pages(sched._cache, padded)
        ev[1].record()
        ev[1].synchronize()
        out = [a for a in out if a is not None]

        def wall(fn):
            t0 = time.monotonic()
            got = fn()
            torch.cuda.synchronize()
            return got, (time.monotonic() - t0) * 1e3

        host, readback = wall(lambda: [sched._to_host(a) for a in out])
        dev, upload = wall(lambda: sched._upload(tuple(host)))
        ev[2].record()
        scatter_pages(sched._cache, torch.zeros(P2, dtype=torch.long), *dev,
                      *([None] * (4 - len(dev))))
        ev[3].record()
        ev[3].synchronize()

        page, page_readback = wall(lambda: [a.cpu() for a in out])
        _, page_upload = wall(lambda: sched._upload(tuple(page)))
        nbytes = sum(a.numel() * a.element_size() for a in host)
        return dict(pages=n, bucket=P2, mb=nbytes / 1e6,
                    gather_ms=ev[0].elapsed_time(ev[1]),
                    readback_ms=readback, upload_ms=upload,
                    scatter_ms=ev[2].elapsed_time(ev[3]),
                    pageable_readback_ms=page_readback,
                    pageable_upload_ms=page_upload)

    return _on_loop(sched, run)


def _tier_wake_ms(sched, key: str, S: int, reps: int = 5) -> float:
    """CUDA-event ms of one wake forward (R = 1, ``S`` suffix positions)
    over the resident session ``key``'s pool KV, on the scheduler thread.
    The block lands past the session's trusted length (its last page's
    slack, then the garbage page), so the session is unchanged."""
    import torch

    def run():
        sess = next(x for x in sched._tier.resident_sessions()
                    if x.key == key)
        table = torch.zeros((1, sched._cache.max_pages_per_row),
                            dtype=torch.int32)
        table[0, :len(sess.pages)] = torch.tensor(sess.pages)
        tokens = torch.full((1, S), 65, dtype=torch.long)
        starts = torch.tensor([sess.length])
        last = torch.tensor([S - 1])
        w = sched._wake_window(S, sess.length)
        sched._wake_forward(tokens, table, starts, last, w)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            sched._wake_forward(tokens, table, starts, last, w)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    return _on_loop(sched, run)


# The router leg's conversations: a new 1500-token one (kernel D on the
# prefill replica, no cached prefix of it there) and a short one under
# the prefix ladder's first grain (the router subprocess's).
ROUTER_PROMPT = ("A new conversation opens with a long question about the "
                 "weekend plans and who brings what. " * 30)[:1500]
ROUTER_SHORT = "One more new conversation, short enough to skip the prefix."


def _stream_turn(label: str, url: str, prompt: str, session: str, ctx=(),
                 trace: str = "", n: int = 24) -> tuple:
    """One greedy streamed /api/generate turn: (client ms to the first
    NDJSON line, client ms to the last, the final record)."""
    body = {"prompt": prompt, "stream": True, "session": session,
            "options": {"num_predict": n}}
    if ctx:
        body["context"] = list(ctx)
    headers = {"Content-Type": "application/json"}
    if trace:
        headers["X-Graft-Trace"] = trace
    req = urllib.request.Request(url + "/api/generate",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    t0 = time.monotonic()
    first_ms, last = None, None
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"{label}: stream {r.status}")
        for line in r:
            if first_ms is None:
                first_ms = (time.monotonic() - t0) * 1e3
            if line.strip():
                last = json.loads(line)
    total_ms = (time.monotonic() - t0) * 1e3
    check(last is not None and last.get("done") is True
          and "error" not in last, f"{label}: bad final record {last}")
    return first_ms, total_ms, last


def _tier_router_leg(results: dict, label: str, ua: str, ub: str) -> None:
    """The port's replica router (serve/router.py) in this process over
    the tier phase's two fronts, A prefill-class and B decode-class
    (scrape 200 ms). A new 1500-token conversation rides the router's
    disaggregated handoff (``disagg_handoffs_total`` 1; kernel D launched
    on A, which woke nothing, and kernel B's verify mode on B, which ran
    no prefill chunk; launch counters zeroed just before), its stream
    equal to A's wake of its own prefill of the same request; the
    follow-up turn goes to B by affinity and wakes there; ``POST
    /admin/drain`` of B through the router migrates B's sessions to A,
    and the next turn equals the unmoved twin's on A; the router's
    ``/metrics`` carries both replicas' series under ``replica="0|1"``,
    each one's ``serve_replica_class`` and the summed fleet totals; a
    router subprocess (``SERVE_ROUTER_UPSTREAMS=<A>,<B> python -m
    p2p_llm_chat_tpu_torch.serve``, no card visible) hands a short new
    conversation off to the same answer as this process's router and
    exits 0 on SIGTERM. Prints the router's added client TTFT on a woken
    turn against the same turn sent straight to a front, the handoff's
    wall split by its spans (A's prefill, B's import, the rest: the
    forget and the router's hops), each migrated session's wall and
    bytes, and the leg's seconds."""
    import uuid
    from p2p_llm_chat_tpu_torch.serve.router import ReplicaRouter
    from p2p_llm_chat_tpu_torch.serve.router import parse_metrics_text

    t_leg = time.monotonic()
    rlabel = label + " router"
    rt = ReplicaRouter([ua, ub], addr="127.0.0.1:0", scrape_ms=200).start()
    proc = None
    try:
        reps = json.loads(_get(rt.url + "/admin/replicas")[1])["replicas"]
        check([(r["class"], r["ready"]) for r in reps]
              == [("prefill", True), ("decode", True)],
              f"{rlabel}: the router's view {reps}")

        # 1. A new conversation through the router: the handoff.
        wrappers = _wrappers()
        ma0, mb0 = _metrics(ua), _metrics(ub)
        for fn in wrappers.values():
            fn.launches = 0
        tid = uuid.uuid4().hex
        ttft1, _, r1 = _stream_turn(rlabel, rt.url, ROUTER_PROMPT, "rt1",
                                    trace=f"{tid};s=1")
        launches = {name: fn.launches for name, fn in wrappers.items()}
        ma1, mb1 = _metrics(ua), _metrics(ub)
        snap = parse_metrics_text(_get(rt.url + "/metrics")[1])
        check(snap.get("disagg_handoffs_total") == 1.0
              and snap.get("disagg_handoff_failures_total") == 0.0,
              f"{rlabel}: handoffs {snap.get('disagg_handoffs_total')}, "
              f"failures {snap.get('disagg_handoff_failures_total')}")
        check(launches["prefill_attention"] > 0
              and launches["paged_attention_verify_append"] > 0,
              f"{rlabel}: the handoff's kernels {launches}")
        check(float(ma1["serve_admitted_total"])
              == float(ma0["serve_admitted_total"]) + 1
              and float(ma1["kv_waked_total"]) == float(ma0["kv_waked_total"]),
              f"{rlabel}: A did not admit the handoff's prefill, or woke a "
              "session")
        check(float(mb1["prefill_chunks_total"])
              == float(mb0["prefill_chunks_total"])
              and float(mb1["kv_waked_total"])
              == float(mb0["kv_waked_total"]) + 1,
              f"{rlabel}: B prefilled, or did not wake the handoff")
        for name, n in launches.items():
            rec = results.get(name)
            if n and rec is not None:
                rec.setdefault("launches_by_path", {})[rlabel] = n
                rec["launches"] = rec.get("launches", 0) + n
        spans = json.loads(_get(f"{rt.url}/admin/trace?id={tid}")[1])[
            "spans"]
        dur = {s["name"]: s["dur_ms"] for s in spans
               if s["name"] in ("disagg.handoff", "disagg.prefill_park",
                                "disagg.import")}
        check(len(dur) == 3, f"{rlabel}: handoff spans {dur}")
        # The twin: A's own prefill of the same request, woken on A.
        status, body = _status("POST", ua + "/admin/disagg/prefill", {
            "path": "/api/generate", "body": {
                "prompt": ROUTER_PROMPT, "session": "rt1-twin",
                "options": {"num_predict": 24}}})
        check(status == 200, f"{rlabel}: twin prefill {status} {body[:200]}")
        wa = float(_metrics(ua)["kv_waked_total"])
        _, _, w1 = _stream_turn(rlabel, ua, ROUTER_PROMPT, "rt1-twin")
        check(float(_metrics(ua)["kv_waked_total"]) == wa + 1,
              f"{rlabel}: A did not wake its twin")
        check(r1["context"] == w1["context"], f"{rlabel}: the routed "
              "handoff's stream differs from A's wake of the same prefill")

        # 2. The follow-up turn: affinity to B, woken there; the twin's
        # turn 2 sent straight to A.
        wb = float(_metrics(ub)["kv_waked_total"])
        ttft2, wall2, r2 = _stream_turn(rlabel, rt.url, TIER_TURN2, "rt1",
                                        r1["context"])
        check(float(_metrics(ub)["kv_waked_total"]) == wb + 1,
              f"{rlabel}: the follow-up did not wake on B")
        ttft2d, wall2d, w2 = _stream_turn(rlabel, ua, TIER_TURN2,
                                          "rt1-twin", w1["context"])
        check(r2["context"] == w2["context"], f"{rlabel}: turn 2 on B "
              "differs from the twin's on A")

        # 3. Drain B through the router: its sessions move to A.
        moving = json.loads(_get(ub + "/admin/session")[1])["sessions"]
        n_samples = len(rt._m_migration_ms._samples)
        t0 = time.monotonic()
        status, body = _status("POST", rt.url + "/admin/drain",
                               {"replica": 1})
        drain_s = time.monotonic() - t0
        mig = json.loads(body).get("migration") or {}
        check(status == 200 and mig.get("migrated") == len(moving)
              and mig.get("failed") == 0 and mig.get("dest") == 0,
              f"{rlabel}: drain {status} {mig} over {len(moving)} sessions")
        on_a = json.loads(_get(ua + "/admin/session")[1])["sessions"]
        check(set(moving) <= set(on_a)
              and not json.loads(_get(ub + "/admin/session")[1])["sessions"],
              f"{rlabel}: the drain left sessions on B")
        walls = rt._m_migration_ms._samples[n_samples:]
        mb = {k: on_a[k]["nbytes"] / 1e6 for k in moving}
        wa = float(_metrics(ua)["kv_waked_total"])
        _, _, r3 = _stream_turn(rlabel, rt.url, TIER_TURN3, "rt1",
                                r2["context"])
        check(float(_metrics(ua)["kv_waked_total"]) == wa + 1,
              f"{rlabel}: the migrated session did not wake on A")
        _, _, w3 = _stream_turn(rlabel, ua, TIER_TURN3, "rt1-twin",
                                w2["context"])
        check(r3["context"] == w3["context"], f"{rlabel}: turn 3 after the "
              "migration differs from the unmoved twin's")
        status, _ = _status("POST", rt.url + "/admin/undrain",
                            {"replica": 1})
        check(status == 200, f"{rlabel}: undrain {status}")

        # 4. The aggregated /metrics.
        snap = parse_metrics_text(_get(rt.url + "/metrics")[1])
        for series in ("serve_requests_total", "kv_waked_total",
                       "kv_parked_total"):
            per = [snap.get(f'{series}{{replica="{i}"}}') for i in (0, 1)]
            check(None not in per and snap.get(series) == sum(per),
                  f"{rlabel}: {series} {per} fleet {snap.get(series)}")
        check(snap.get('serve_replica_class{class="prefill",replica="0"}')
              == 1.0 and snap.get(
                  'serve_replica_class{class="decode",replica="1"}') == 1.0
              and snap.get("kv_sessions_migrated_total") == len(moving),
              f"{rlabel}: the router's /metrics {snap}")

        # 5. The entry in router mode, in a process that sees no card.
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        sub_url = f"http://127.0.0.1:{port}"
        env = dict(os.environ, SERVE_ROUTER_UPSTREAMS=f"{ua},{ub}",
                   SERVE_ADDR=f"127.0.0.1:{port}", CUDA_VISIBLE_DEVICES="",
                   SERVE_ROUTER_SCRAPE_MS="200", OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        deadline = time.monotonic() + 120
        while True:
            check(proc.poll() is None, f"{rlabel}: the router process "
                  f"exited {proc.returncode}")
            check(time.monotonic() < deadline, f"{rlabel}: the router "
                  "process never answered /readyz")
            try:
                if _get(sub_url + "/readyz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        sub = _tier_gen(rlabel, sub_url, ROUTER_SHORT, "rt-sub")
        here = _tier_gen(rlabel, rt.url, ROUTER_SHORT, "rt-here")
        check(sub["context"] == here["context"], f"{rlabel}: the router "
              "process's answer differs from this process's router's")
        sub_snap = parse_metrics_text(_get(sub_url + "/metrics")[1])
        check(sub_snap.get("disagg_handoffs_total") == 1.0,
              f"{rlabel}: the router process handed nothing off")
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            rc = None
        err = proc.stderr.read().decode(errors="replace")
        proc = None
        check(rc == 0, f"{rlabel}: the router process exited {rc} on "
              f"SIGTERM: {err[-2000:]}")
        leg_s = time.monotonic() - t_leg
        # The router's cost on a woken turn: what the client waits past
        # the replica's own clock, routed less straight to a front (the
        # replicas' decode walls drop out).
        over = (ttft2 - r2["prompt_eval_duration"] / 1e6) - (
            ttft2d - w2["prompt_eval_duration"] / 1e6)
        over_wall = (wall2 - r2["total_duration"] / 1e6) - (
            wall2d - w2["total_duration"] / 1e6)
        rest = dur["disagg.handoff"] - dur["disagg.prefill_park"] - dur[
            "disagg.import"]
        print(f"server {rlabel}: handoff of {r1['prompt_eval_count']} "
              f"prompt tokens: client TTFT {ttft1:.1f} ms (B's "
              f"prompt_eval {r1['prompt_eval_duration'] / 1e6:.1f} ms); "
              f"handoff {dur['disagg.handoff']:.1f} ms = A's prefill "
              f"{dur['disagg.prefill_park']:.1f} + B's import "
              f"{dur['disagg.import']:.1f} + forget and hops {rest:.1f}; "
              f"kernel launches {launches}", flush=True)
        print(f"server {rlabel}: woken turn 2 client TTFT routed (B) "
              f"{ttft2:.1f} ms, straight to A {ttft2d:.1f} ms; replica "
              f"prompt_eval {r2['prompt_eval_duration'] / 1e6:.1f} / "
              f"{w2['prompt_eval_duration'] / 1e6:.1f} ms; the router's "
              f"added client TTFT {over:.2f} ms; client wall past the "
              f"replica's total_duration routed "
              f"{wall2 - r2['total_duration'] / 1e6:.2f} ms, straight "
              f"{wall2d - w2['total_duration'] / 1e6:.2f} ms (the router "
              f"adds {over_wall:.2f} ms)", flush=True)
        print(f"server {rlabel}: drain of B migrated {len(moving)} sessions "
              f"to A in {drain_s:.2f} s: walls ms "
              f"{[round(w, 1) for w in walls]}, MB by key "
              f"{ {k: round(v, 1) for k, v in mb.items()} }; turn 3 woken "
              f"on A = the unmoved twin's; router subprocess answer equal, "
              f"exit 0 on SIGTERM; leg {leg_s:.1f} s", flush=True)
        results["_router"] = dict(
            handoff_ms=round(dur["disagg.handoff"], 3),
            prefill_ms=round(dur["disagg.prefill_park"], 3),
            import_ms=round(dur["disagg.import"], 3),
            forget_and_hops_ms=round(rest, 3),
            ttft_handoff_ms=round(ttft1, 3),
            ttft_woken_routed_ms=round(ttft2, 3),
            ttft_woken_direct_ms=round(ttft2d, 3),
            router_added_ttft_ms=round(over, 3),
            router_added_wall_ms=round(over_wall, 3),
            drain_s=round(drain_s, 3),
            migration_ms=[round(w, 3) for w in walls],
            migration_mb={k: round(v, 3) for k, v in mb.items()},
            leg_s=round(leg_s, 1))
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=10)
        rt.stop()


def phase_server_tier(results: dict) -> None:
    """The KV tier on the card: two engines in one process, A of class
    prefill and B of class decode, each llama3.1-8b int8 (32 layers, int8
    pool, 8 slots, max_seq 4096, chunked prefill at 256, the prefix cache
    on, SERVE_KV_HOST_GB=8, SERVE_KV_IDLE_S large; B with a 200-page pool),
    behind their fronts. Checks, in order: two sessions with identical
    1500-token first turns retain on A; one parks (engine ``park_all``);
    turn 2 of both — a resident and a parked wake — gives bitwise-equal
    greedy streams, through kernel B's verify mode and kernel A (launch
    counters zeroed just before); the same turn admits cold on B (no
    session there), its stream compared; an auto-promoted prefix entry
    exported from A and imported on B serves B's next admission;
    ``/admin/session/park_all`` on A, export -> pull-import on B -> forget
    on A, and turn 3 on B equals turn 3 of the other session on A; the
    export and import failpoints fail their routes and lose no session;
    pool pressure on B parks resident sessions for new admissions; then
    the replica router over both fronts (:func:`_tier_router_leg`: the
    handoff, affinity, drain-as-migration, the fleet's ``/metrics`` and
    the entry in router mode). Prints the wake TTFT
    beside the cold admission's, the park copy's gather + readback and
    the wake's upload + scatter (ms, MB), the wake forward at S = 64 and
    256, and the export's host ms. The weights are built once, for both
    engines and for the dense leg that follows (:func:`_tier_dense_leg`:
    the same checks over the dense cache, but pool pressure)."""
    import torch
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    from p2p_llm_chat_tpu_torch.utils import failpoints

    label = "llama3.1-8b int8 tier"
    cfg = get_config("llama3.1-8b")
    params = family_for(cfg).init_params_quantized(cfg, seed=0, quant="int8",
                                                   device="cuda")
    env = dict(SERVE_BACKEND="torch", MODEL_CONFIG="llama3.1-8b",
               SERVE_KV="paged", SERVE_QUANT="int8", SERVE_KV_QUANT="int8",
               SERVE_SLOTS="8", SERVE_MAX_SEQ="4096", SERVE_DEVICE="cuda",
               SERVE_PREFILL_CHUNK="256", SERVE_PREFIX="1",
               PAGED_ATTN_IMPL="gather", SERVE_KV_HOST_GB="8",
               SERVE_KV_IDLE_S="1000000")
    engines, servers = [], []
    try:
        for cls, pages in (("prefill", "0"), ("decode", "200")):
            os.environ.update(env, SERVE_REPLICA_CLASS=cls,
                              SERVE_PAGES=pages)
            t0 = time.monotonic()
            eng = build_engine_from_env(params=params)
            engines.append(eng)
            servers.append(OllamaServer(eng, addr="127.0.0.1:0").start())
            deadline = time.monotonic() + 600
            while not eng.ready():
                check(eng.warmup_error is None,
                      f"{label}: warmup failed: {eng.warmup_error!r}")
                check(time.monotonic() < deadline, f"{label}: never ready")
                time.sleep(0.1)
            ready = json.loads(_get(servers[-1].url + "/readyz")[1])
            check(ready.get("class") == cls, f"{label}: /readyz {ready}")
            print(f"server {label}: engine {cls} ready in "
                  f"{time.monotonic() - t0:.1f} s ({eng.scheduler.num_pages} "
                  f"pages, {len(eng.scheduler._wake_shapes_run)} wake shapes "
                  f"warmed); {torch.cuda.memory_allocated() / 1e9:.2f} GB "
                  "allocated", flush=True)
        A, B = engines
        ua, ub = (srv.url for srv in servers)
        sa, sb = A.scheduler, B.scheduler
        check(f'serve_replica_class{{class="decode"}} 1' in
              _get(ub + "/metrics")[1], f"{label}: B's class on /metrics")
        long_prompt = LONG_PROMPT

        # 1. Two sessions, identical first turns, retained on A.
        reqs = [("/api/generate", {"prompt": long_prompt, "stream": False,
                                   "session": s, "options":
                                   {"num_predict": 24}})
                for s in ("s1", "s2")]
        answers, _ = _burst(ua, reqs)
        t1 = []
        for ans in answers:
            check(not isinstance(ans, Exception) and ans[0] == 200,
                  f"{label}: turn 1 {ans!r}")
            t1.append(json.loads(ans[1]))
        check(t1[0]["context"] == t1[1]["context"], f"{label}: identical "
              "first turns differ")
        _quiesce(sa)
        m = _metrics(ua)
        check(float(m["kv_resident_sessions"]) == 2, f"{label}: "
              f"kv_resident_sessions {m['kv_resident_sessions']}")

        # 2. Park only s2 (after timing the copy's parts on s1).
        copy = _tier_copy_times(sa, "sid:s1")
        wake_fwd = {S: _tier_wake_ms(sa, "sid:s1", S) for S in (64, 256)}
        free0 = float(m["serve_kv_free_pages"])
        parked0 = float(m["kv_parked_total"])
        t0 = time.monotonic()
        sa.park_all(key="sid:s2")
        park_wall = (time.monotonic() - t0) * 1e3
        m = _metrics(ua)
        check(float(m["kv_parked_total"]) == parked0 + 1
              and float(m["kv_parked_sessions"]) == 1
              and float(m["serve_kv_free_pages"]) > free0,
              f"{label}: the park moved nothing: {m}")
        print(f"server {label}: session of {len(t1[0]['context']) - 1} "
              f"tokens = {copy['pages']} pages (bucket {copy['bucket']}), "
              f"{copy['mb']:.1f} MB parked: gather {copy['gather_ms']:.3f} "
              f"ms + readback {copy['readback_ms']:.3f} ms; upload "
              f"{copy['upload_ms']:.3f} ms + scatter "
              f"{copy['scatter_ms']:.3f} ms (through pageable memory "
              f"instead: readback {copy['pageable_readback_ms']:.3f} ms, "
              f"upload {copy['pageable_upload_ms']:.3f} ms); park_all(key) "
              f"{park_wall:.1f} ms wall (handshake included); "
              f"serve_kv_free_pages {free0:.0f} -> "
              f"{float(m['serve_kv_free_pages']):.0f}; wake forward "
              f"(R=1, 32 layers) S=64 {wake_fwd[64]:.3f} ms, S=256 "
              f"{wake_fwd[256]:.3f} ms", flush=True)

        # 3. Turn 2: a resident wake (s1) and a parked wake (s2).
        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        waked0 = float(m["kv_waked_total"])
        t2 = [_tier_gen(label, ua, TIER_TURN2, s, t1[i]["context"])
              for i, s in enumerate(("s1", "s2"))]
        launches = {name: fn.launches for name, fn in wrappers.items()}
        check(t2[0]["context"] == t2[1]["context"], f"{label}: the parked "
              "wake's greedy stream differs from the resident wake's")
        m = _metrics(ua)
        check(float(m["kv_waked_total"]) == waked0 + 2, f"{label}: "
              f"kv_waked_total {m['kv_waked_total']} (want {waked0 + 2})")
        for name in ("paged_attention_verify_append", "quant_matmul",
                     "paged_attention_append"):
            check(launches[name] > 0, f"{label}: {name} was never launched "
                  f"by the wakes: {launches}")
        for name, n in launches.items():
            rec = results.get(name)
            if n and rec is not None:
                rec.setdefault("launches_by_path", {})[label] = n
                rec["launches"] = rec.get("launches", 0) + n
        cold = _tier_gen(label, ub, TIER_TURN2, "cold-t2", t1[0]["context"])
        check(float(_metrics(ub)["kv_waked_total"]) == 0, f"{label}: the "
              "cold turn woke a session on B")
        diff = _first_diff(cold["context"], t2[0]["context"])
        n_prompt = t2[0]["prompt_eval_count"]
        print(f"server {label}: turn 2 ({n_prompt} prompt tokens, "
              f"{n_prompt - len(t1[0]['context'])} new) TTFT: resident wake "
              f"{t2[0]['prompt_eval_duration'] / 1e6:.1f} ms, parked wake "
              f"{t2[1]['prompt_eval_duration'] / 1e6:.1f} ms, admitted cold "
              f"on B {cold['prompt_eval_duration'] / 1e6:.1f} ms; greedy "
              "streams: resident = parked (bitwise); cold "
              + ("= wake" if diff < 0 else f"differs from the wake from "
                 f"context position {diff} (generated token "
                 f"{diff - n_prompt})") + f"; kernel launches {launches}",
              flush=True)

        # 6. Prefix: A's auto-promoted head, exported and pulled into B.
        deadline = time.monotonic() + 60
        h = None
        while h is None:
            got = json.loads(_get(ua + "/admin/prefix")[1])["prefixes"]
            h = next((k for k, v in got.items() if v["len"] == 512), None)
            check(h is not None or time.monotonic() < deadline,
                  f"{label}: A promoted no 512-token prefix: {got}")
            time.sleep(0.1)
        t0 = time.monotonic()
        status, body = _status("POST", ub + "/admin/prefix/import",
                               {"from": ua, "h": h})
        pull_ms = (time.monotonic() - t0) * 1e3
        check(status == 200 and json.loads(body)["len"] == 512,
              f"{label}: prefix import {status} {body[:200]!r}")
        m0 = _metrics(ub)
        _tier_gen(label, ub, long_prompt + " And now a different ending.",
                  "pfx", n=8)
        m1 = _metrics(ub)
        check(float(m1["prefix_hits_total"]) > float(m0["prefix_hits_total"])
              and float(m1["serve_prefix_admits_total"])
              > float(m0["serve_prefix_admits_total"]),
              f"{label}: B's admission did not use the imported prefix")
        print(f"server {label}: prefix {h[:12]}.. (512 tokens) exported "
              f"from A, pulled into B ({pull_ms:.1f} ms: A's export, the "
              "transfer and B's import), used by B's next admission "
              f"(prefix_hits_total {m0['prefix_hits_total']} -> "
              f"{m1['prefix_hits_total']})", flush=True)

        # 4. Migration: park all on A, export s1 -> pull-import on B ->
        # forget on A; turn 3 of s1 on B equals turn 3 of s2 on A.
        status, body = _status("POST", ua + "/admin/session/park_all", {})
        sessions = json.loads(body)["sessions"]
        check(status == 200 and all(v["parked"] for v in sessions.values()),
              f"{label}: park_all {status} {sessions}")
        t0 = time.monotonic()
        payload = sa._tier.export_payload("sid:s1")
        export_ms = (time.monotonic() - t0) * 1e3
        check(payload is not None, f"{label}: no export of sid:s1")
        status, body = _status("POST", ub + "/admin/session/import",
                               {"from": ua, "key": "sid:s1"})
        check(status == 200, f"{label}: import {status} {body[:200]!r}")
        status, _ = _status("POST", ua + "/admin/session/forget",
                            {"key": "sid:s1"})
        check(status == 200 and "sid:s1" not in A.session_list(),
              f"{label}: forget {status}")
        wb = float(_metrics(ub)["kv_waked_total"])
        t3b = _tier_gen(label, ub, TIER_TURN3, "s1", t2[0]["context"])
        t3a = _tier_gen(label, ua, TIER_TURN3, "s2", t2[1]["context"])
        check(t3b["context"] == t3a["context"], f"{label}: turn 3 on B "
              "(migrated) differs from turn 3 on A")
        check(float(_metrics(ub)["kv_waked_total"]) == wb + 1,
              f"{label}: the migrated session did not wake on B")
        print(f"server {label}: park_all -> export ({len(payload) / 1e6:.1f}"
              f" MB npz, {export_ms:.1f} ms host) -> pull-import on B -> "
              "forget on A; turn 3 woken on B = turn 3 on A (TTFT "
              f"{t3b['prompt_eval_duration'] / 1e6:.1f} / "
              f"{t3a['prompt_eval_duration'] / 1e6:.1f} ms)", flush=True)

        # 7. The export and import failpoints: routes fail, nothing lost.
        try:
            failpoints.arm("serve.kv_tier.export", "raise")
            status, _ = _status("GET",
                                ua + "/admin/session/export?key=sid:s2")
            check(status == 500, f"{label}: armed export answered {status}")
            check("sid:s2" in A.session_list(), f"{label}: the export "
                  "fault lost the session")
            failpoints.disarm_all()
            before = set(B.session_list())
            failpoints.arm("serve.kv_tier.import", "raise")
            status, _ = _status("POST", ub + "/admin/session/import",
                                {"from": ua, "key": "sid:s2"})
            check(status == 500, f"{label}: armed import answered {status}")
            check(set(B.session_list()) == before
                  and "sid:s2" in A.session_list(), f"{label}: the import "
                  "fault changed a tier")
        finally:
            failpoints.disarm_all()
        print(f"server {label}: serve.kv_tier.export / .import armed: "
              "both routes answered 500, no session lost", flush=True)

        # 8. Pool pressure on B parks resident sessions.
        m0 = _metrics(ub)
        reqs = [("/api/generate", {"prompt": f"p{i} " + long_prompt,
                                   "stream": False, "session": f"pp{i}",
                                   "options": {"num_predict": 16}})
                for i in range(6)]
        answers, _ = _burst(ub, reqs)
        for ans in answers:
            check(not isinstance(ans, Exception) and ans[0] == 200,
                  f"{label}: pressure burst {ans!r}")
        _quiesce(sb)
        m1 = _metrics(ub)
        check(float(m1["kv_parked_total"]) > float(m0["kv_parked_total"]),
              f"{label}: pool pressure parked nothing")
        print(f"server {label}: pool pressure on B ({sb.num_pages - 1} "
              "pages): kv_parked_total "
              f"{m0['kv_parked_total']} -> {m1['kv_parked_total']}, "
              f"kv_open_sessions {m1['kv_open_sessions']}, kv_host_bytes "
              f"{m1['kv_host_bytes']}; A: kv_waked_total "
              f"{_metrics(ua)['kv_waked_total']}, B: "
              f"{m1['kv_waked_total']}", flush=True)
        _tier_router_leg(results, label, ua, ub)
        for name, rec in results.items():
            if name == "paged_attention_verify_append":
                rec["tier"] = dict(
                    park_mb=round(copy["mb"], 3),
                    gather_ms=round(copy["gather_ms"], 4),
                    readback_ms=round(copy["readback_ms"], 4),
                    upload_ms=round(copy["upload_ms"], 4),
                    scatter_ms=round(copy["scatter_ms"], 4),
                    pageable_readback_ms=round(
                        copy["pageable_readback_ms"], 4),
                    pageable_upload_ms=round(copy["pageable_upload_ms"], 4),
                    wake_forward_ms={str(k): round(v, 4)
                                     for k, v in wake_fwd.items()},
                    wake_ttft_ms=[round(r["prompt_eval_duration"] / 1e6, 3)
                                  for r in t2],
                    cold_ttft_ms=round(cold["prompt_eval_duration"] / 1e6,
                                       3),
                    export_ms=round(export_ms, 3),
                    export_mb=round(len(payload) / 1e6, 3))
    finally:
        for srv in servers:
            srv.stop()
        for eng in engines:
            eng.stop()
        for k in ("SERVE_KV_HOST_GB", "SERVE_KV_IDLE_S",
                  "SERVE_REPLICA_CLASS", "SERVE_PAGES"):
            os.environ.pop(k, None)
        _free()
    _tier_dense_leg(results, params)


def _tier_dense_copies(sched, key: str) -> dict:
    """On the scheduler thread, for the parked dense session ``key``: the
    wake's upload of its payload as a wake does it (host clock to the end
    of the copy) and its install into a free row (CUDA events; the row is
    free, so no live slot changes), and the park's copy out of that row
    timed apart: the slice copy (events) and the readback into pinned
    host memory (host clock)."""
    import torch

    def run():
        sess = sched._tier._sessions[key]
        (k, v), W = sess.host
        row = sched._free_rows()[0]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        dev = sched._upload((k, v))
        torch.cuda.synchronize()
        upload = (time.monotonic() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        sched._cache.k[:, row, :W].copy_(dev[0])
        sched._cache.v[:, row, :W].copy_(dev[1])
        ev[1].record()
        out = [a[:, row, :W].clone() for a in (sched._cache.k,
                                               sched._cache.v)]
        ev[2].record()
        ev[2].synchronize()
        t0 = time.monotonic()
        host = [sched._to_host(a) for a in out]
        readback = (time.monotonic() - t0) * 1e3
        check(all(torch.equal(h, a) for h, a in zip(host, (k, v))),
              "server_tier dense: the row read back differs from its "
              "payload")
        return dict(W=W, mb=sum(a.numel() * a.element_size()
                                for a in host) / 1e6,
                    upload_ms=upload, install_ms=ev[0].elapsed_time(ev[1]),
                    slice_ms=ev[1].elapsed_time(ev[2]),
                    readback_ms=readback)

    return _on_loop(sched, run)


def _tier_dense_wake_ms(sched, start: int, S: int, reps: int = 5) -> float:
    """CUDA-event ms of one dense wake forward (R = 1, ``S`` suffix
    positions at session length ``start``) into a free row, on the
    scheduler thread (its writes land in slots no slot trusts)."""
    import torch

    def run():
        row = torch.tensor(sched._free_rows()[:1], dtype=torch.long)
        tokens = torch.full((1, S), 65, dtype=torch.long)
        starts = torch.tensor([start])
        last = torch.tensor([S - 1])
        w = sched._wake_window(S, start)
        sched._wake_forward(tokens, row, starts, last, w)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        begin.record()
        for _ in range(reps):
            sched._wake_forward(tokens, row, starts, last, w)
        end.record()
        end.synchronize()
        return begin.elapsed_time(end) / reps

    return _on_loop(sched, run)


def _against_cold(label: str, sched, what: str, woken: list,
                  cold: list, n_prompt: int) -> str:
    """A woken stream against the same request admitted cold: equal, or
    their first difference is a near tie. The wake and the cold prefill
    reach a position's logits through different kernels (kernel B's
    verify mode against kernel D and the prefill matmuls), so bf16
    roundings differ; where the streams part, a third forward (the
    family's ``prefill`` of the cold context up to that position, on the
    scheduler thread) must put the two chosen tokens' logits within
    STEP_TOL of its largest |logit| (the step phases' tolerance between
    two paths that round in another order). Returns the line to
    print."""
    import torch
    from p2p_llm_chat_tpu_torch.serve.scheduler import _bucket
    diff = _first_diff(cold, woken)
    if diff < 0:
        return f"{what} = the cold run"
    check(n_prompt <= diff < min(len(cold), len(woken)),
          f"{label}: {what} parts from the cold run at context position "
          f"{diff}, inside the prompt or past a stream's end")

    def run():
        ids = cold[:diff]
        S = _bucket(len(ids), sched.max_seq)
        toks = torch.zeros((1, S), dtype=torch.long, device=sched.device)
        toks[0, :len(ids)] = torch.tensor(ids, device=sched.device)
        lens = torch.tensor([len(ids)], device=sched.device)
        logits = sched._family.prefill(sched._params, sched.config, toks,
                                       lens, last_only=True)[0][0, 0]
        return (float(logits[cold[diff]] - logits[woken[diff]]),
                float(logits.abs().max()))

    gap, scale = _on_loop(sched, run)
    check(abs(gap) <= STEP_TOL * scale, f"{label}: {what} parts from the "
          f"cold run at generated token {diff - n_prompt}, and it is no near "
          f"tie: logit gap {gap:.4f} of max|logit| {scale:.3f}")
    return (f"{what} parts from the cold run at generated token "
            f"{diff - n_prompt}, a near tie (the two tokens' logits "
            f"{abs(gap):.4f} apart, max|logit| {scale:.3f})")


def _tier_dense_leg(results: dict, params) -> None:
    """The KV tier over the dense cache (the reference's default layout):
    engines A' (prefill class) and B' (decode class), llama3.1-8b int8 on
    ``params`` over bf16 dense caches of 8 x 4096, SERVE_KV_HOST_GB=8,
    behind their fronts. Checks: two identical 1500-token first turns
    park at finish (no resident phase: counts (0, 2)); turn 2 of both
    wakes on A' (counters zeroed before: kernel B's verify mode on the
    cache's identity view, kernel A and A8's decode mode; kernel B's
    paged decode modes never), the two streams bitwise equal and equal to
    the same turn admitted cold on B'; export, pull-import on B' and
    forget on A', then turn 3 woken on B' equals turn 3 of the other
    session on A'; the three calls of a disaggregated handoff, the
    request woken on B' equal to a cold run; the export and import
    failpoints lose no session. Prints each park's stall in the serving
    loop (ms, W, MB), the woken TTFT against the cold one, the park copy
    and the wake's upload + install timed apart, and the wake forward at
    S = 64 and 256."""
    import torch
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    from p2p_llm_chat_tpu_torch.utils import failpoints

    label = "llama3.1-8b int8 tier dense"
    engines, servers = [], []
    parks: list = []
    try:
        for cls in ("prefill", "decode"):
            _serve_env(MODEL_CONFIG="llama3.1-8b", SERVE_KV="dense",
                       SERVE_QUANT="int8", PAGED_ATTN_IMPL="gather",
                       SERVE_KV_HOST_GB="8", SERVE_KV_IDLE_S="1000000",
                       SERVE_REPLICA_CLASS=cls)
            t0 = time.monotonic()
            eng = build_engine_from_env(params=params)
            engines.append(eng)
            servers.append(OllamaServer(eng, addr="127.0.0.1:0").start())
            ready_s = _wait_ready(f"server {label}", eng)
            check(eng.scheduler.kv_mode == "dense", f"{label}: kv_mode "
                  f"{eng.scheduler.kv_mode}")
            ready = json.loads(_get(servers[-1].url + "/readyz")[1])
            check(ready.get("class") == cls, f"{label}: /readyz {ready}")
            print(f"server {label}: engine {cls} ready in "
                  f"{time.monotonic() - t0:.1f} s ({ready_s:.1f} s warmup, "
                  f"{len(eng.scheduler._wake_shapes_run)} wake shapes "
                  f"warmed); bf16 dense KV "
                  f"{eng.scheduler._cache.nbytes() / 1e9:.3f} GB; "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
                  flush=True)
        A, B = engines
        ua, ub = (srv.url for srv in servers)
        sa, sb = A.scheduler, B.scheduler
        inner = sa._park_row

        def timed_park(key, tokens, row):
            t0 = time.monotonic()
            inner(key, tokens, row)
            sess = sa._tier._sessions.get(key)
            parks.append(((time.monotonic() - t0) * 1e3,
                          sess.host[1] if sess else 0,
                          sess.nbytes / 1e6 if sess else 0.0))

        sa._park_row = timed_park

        # 1. Two sessions, identical first turns, parked at finish on A'.
        reqs = [("/api/generate", {"prompt": LONG_PROMPT, "stream": False,
                                   "session": s, "options":
                                   {"num_predict": 24}})
                for s in ("s1", "s2")]
        answers, _ = _burst(ua, reqs)
        t1 = []
        for ans in answers:
            check(not isinstance(ans, Exception) and ans[0] == 200,
                  f"{label}: turn 1 {ans!r}")
            t1.append(json.loads(ans[1]))
        check(t1[0]["context"] == t1[1]["context"], f"{label}: identical "
              "first turns differ")
        _quiesce(sa)
        check(sa._tier.counts() == (0, 2), f"{label}: tier counts "
              f"{sa._tier.counts()} after two finished first turns (want "
              "(0, 2): parked at finish)")
        m = _metrics(ua)
        check(float(m["kv_parked_total"]) == 2, f"{label}: kv_parked_total "
              f"{m['kv_parked_total']}")
        copy = _tier_dense_copies(sa, "sid:s1")
        n_tok = len(t1[0]["context"]) - 1
        wake_fwd = {S: _tier_dense_wake_ms(sa, n_tok, S) for S in (64, 256)}
        print(f"server {label}: session of {n_tok} tokens parked at finish "
              f"(W = {copy['W']}, {copy['mb']:.1f} MB): the park's stall in "
              "the loop " + ", ".join(f"{ms:.1f} ms (W {W}, {mb:.1f} MB)"
                                      for ms, W, mb in parks)
              + f"; timed apart: slice {copy['slice_ms']:.3f} ms + pinned "
              f"readback {copy['readback_ms']:.3f} ms; the wake's upload "
              f"{copy['upload_ms']:.3f} ms + install "
              f"{copy['install_ms']:.3f} ms; wake forward (R=1, 32 layers) "
              f"S=64 {wake_fwd[64]:.3f} ms, S=256 {wake_fwd[256]:.3f} ms",
              flush=True)

        # 2. Turn 2 of both: two parked wakes on A', then cold on B'.
        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        t2 = [_tier_gen(label, ua, TIER_TURN2, s, t1[i]["context"])
              for i, s in enumerate(("s1", "s2"))]
        launches = {name: fn.launches for name, fn in wrappers.items()}
        check(t2[0]["context"] == t2[1]["context"], f"{label}: the two "
              "woken turn-2 streams differ")
        check(float(_metrics(ua)["kv_waked_total"]) == 2, f"{label}: "
              "kv_waked_total after turn 2")
        for name in ("paged_attention_verify_append", "quant_matmul",
                     "dense_attention"):
            check(launches[name] > 0, f"{label}: {name} was never launched "
                  f"by the wakes: {launches}")
        for name in ("paged_attention_append", "paged_attention"):
            check(launches[name] == 0, f"{label}: {name} was launched "
                  f"{launches[name]} times over the dense cache")
        _record_launches(results, "server_tier dense", launches)
        cold = _tier_gen(label, ub, TIER_TURN2, "cold-t2", t1[0]["context"])
        check(float(_metrics(ub)["kv_waked_total"]) == 0, f"{label}: the "
              "cold turn woke a session on B'")
        n_prompt = t2[0]["prompt_eval_count"]
        vs_cold = _against_cold(label, sb, "the woken turn 2",
                                t2[0]["context"], cold["context"], n_prompt)
        ttft = [r["prompt_eval_duration"] / 1e6 for r in t2]
        cold_ms = cold["prompt_eval_duration"] / 1e6
        print(f"server {label}: turn 2 ({n_prompt} prompt tokens, "
              f"{n_prompt - len(t1[0]['context'])} new) TTFT: woken "
              f"{ttft[0]:.1f} / {ttft[1]:.1f} ms, admitted cold on B' "
              f"{cold_ms:.1f} ms; greedy: woken streams equal, {vs_cold}; "
              f"kernel launches {launches}", flush=True)

        # 3. Migration: export s1 (already parked), pull-import on B',
        # forget on A'; turn 3 on B' equals turn 3 of s2 on A'.
        _quiesce(sa)
        t0 = time.monotonic()
        payload = A.session_export("sid:s1")
        export_ms = (time.monotonic() - t0) * 1e3
        check(payload is not None, f"{label}: no export of sid:s1")
        status, body = _status("POST", ub + "/admin/session/import",
                               {"from": ua, "key": "sid:s1"})
        check(status == 200, f"{label}: import {status} {body[:200]!r}")
        status, _ = _status("POST", ua + "/admin/session/forget",
                            {"key": "sid:s1"})
        check(status == 200 and "sid:s1" not in A.session_list(),
              f"{label}: forget {status}")
        wb = float(_metrics(ub)["kv_waked_total"])
        t3b = _tier_gen(label, ub, TIER_TURN3, "s1", t2[0]["context"])
        t3a = _tier_gen(label, ua, TIER_TURN3, "s2", t2[1]["context"])
        check(t3b["context"] == t3a["context"], f"{label}: turn 3 on B' "
              "(migrated) differs from turn 3 on A'")
        check(float(_metrics(ub)["kv_waked_total"]) == wb + 1,
              f"{label}: the migrated session did not wake on B'")
        print(f"server {label}: export ({len(payload) / 1e6:.1f} MB npz, "
              f"{export_ms:.1f} ms host) -> pull-import on B' -> forget on "
              "A'; turn 3 woken on B' = turn 3 on A' (TTFT "
              f"{t3b['prompt_eval_duration'] / 1e6:.1f} / "
              f"{t3a['prompt_eval_duration'] / 1e6:.1f} ms)", flush=True)

        # 4. The disaggregated handoff's three calls.
        d_prompt = ("A new conversation opens with a long question about "
                    "the weekend plans. " * 8)
        body_d = {"prompt": d_prompt, "stream": False, "session": "d1",
                  "options": {"num_predict": 24}}
        status, body = _status("POST", ua + "/admin/disagg/prefill",
                               {"path": "/api/generate", "body": body_d})
        meta = json.loads(body)
        check(status == 200 and meta.get("key") == "sid:d1"
              and meta.get("parked") is True,
              f"{label}: disagg prefill {status} {meta}")
        status, snap = _status("GET", ua + "/admin/session/export?key=sid:d1")
        check(status == 200, f"{label}: export of sid:d1 {status}")
        status, body = _status("POST", ub + "/admin/session/import",
                               {"from": ua, "key": "sid:d1"})
        check(status == 200, f"{label}: handoff import {status}")
        status, _ = _status("POST", ua + "/admin/session/forget",
                            {"key": "sid:d1"})
        check(status == 200, f"{label}: handoff forget {status}")
        wb = float(_metrics(ub)["kv_waked_total"])
        on_b = _tier_gen(label, ub, d_prompt, "d1")
        check(float(_metrics(ub)["kv_waked_total"]) == wb + 1,
              f"{label}: the handed-off request did not wake on B'")
        status, _ = _status("POST", ua + "/admin/session/import", raw=snap)
        check(status == 200, f"{label}: re-import on A' {status}")
        on_a = _tier_gen(label, ua, d_prompt, "d1")
        check(on_b["context"] == on_a["context"], f"{label}: the handoff "
              "woken on B' differs from the wake of the same payload on A'")
        cold_d = _tier_gen(label, ub, d_prompt, "d-cold")
        vs_cold = _against_cold(label, sb, "the handoff woken on B'",
                                on_b["context"], cold_d["context"],
                                on_b["prompt_eval_count"])
        print(f"server {label}: disaggregated handoff of {meta['len']} "
              f"tokens: woken on B' = the wake of the same payload on A'; "
              f"{vs_cold}; TTFT woken "
              f"{on_b['prompt_eval_duration'] / 1e6:.1f} ms, cold "
              f"{cold_d['prompt_eval_duration'] / 1e6:.1f} ms", flush=True)

        # 5. The export and import failpoints: routes fail, nothing lost.
        try:
            failpoints.arm("serve.kv_tier.export", "raise")
            status, _ = _status("GET",
                                ua + "/admin/session/export?key=sid:s2")
            check(status == 500, f"{label}: armed export answered {status}")
            check("sid:s2" in A.session_list(), f"{label}: the export "
                  "fault lost the session")
            failpoints.disarm_all()
            before = set(B.session_list())
            failpoints.arm("serve.kv_tier.import", "raise")
            status, _ = _status("POST", ub + "/admin/session/import",
                                {"from": ua, "key": "sid:s2"})
            check(status == 500, f"{label}: armed import answered {status}")
            check(set(B.session_list()) == before
                  and "sid:s2" in A.session_list(), f"{label}: the import "
                  "fault changed a tier")
        finally:
            failpoints.disarm_all()
        print(f"server {label}: serve.kv_tier.export / .import armed: "
              "both routes answered 500, no session lost", flush=True)
        results["_server_tier_dense"] = dict(
            park_stall_ms=[round(ms, 3) for ms, _, _ in parks],
            park_W=copy["W"], park_mb=round(copy["mb"], 3),
            slice_ms=round(copy["slice_ms"], 4),
            readback_ms=round(copy["readback_ms"], 4),
            upload_ms=round(copy["upload_ms"], 4),
            install_ms=round(copy["install_ms"], 4),
            wake_forward_ms={str(k): round(v, 4)
                             for k, v in wake_fwd.items()},
            wake_ttft_ms=[round(t, 3) for t in ttft],
            cold_ttft_ms=round(cold_ms, 3), export_ms=round(export_ms, 3),
            export_mb=round(len(payload) / 1e6, 3),
            wake_launches=launches.get("paged_attention_verify_append", 0))
    finally:
        for srv in servers:
            srv.stop()
        for eng in engines:
            eng.stop()
        for k in ("SERVE_KV_HOST_GB", "SERVE_KV_IDLE_S",
                  "SERVE_REPLICA_CLASS"):
            os.environ.pop(k, None)


# -- checkpoints written here (server_ckpt, server_multi) ------------------

# llama3's specials at llama3's ids; the other ids up to 128255 are its
# reserved tokens.
LLAMA3_SPECIALS = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                   "<|start_header_id|>": 128006,
                   "<|end_header_id|>": 128007, "<|eot_id|>": 128009}
BPE_MERGES = 1024
CKPT_SEED = 14
SHARD_BYTES = 5_000_000_000


def _bpe_merges(text: str, n: int) -> list:
    """Byte-level BPE training in pure Python: the pretokens of ``text``
    (the port's llama3 regex, GPT-2's byte symbols), then ``n`` times the
    most frequent adjacent pair (ties to the smaller pair) merged."""
    import collections
    from p2p_llm_chat_tpu_torch.tokenizer import (_PRETOKEN_RE,
                                                  _byte_to_unicode)
    b2u = _byte_to_unicode()
    words = collections.Counter(
        tuple(b2u[b] for b in piece.encode("utf-8"))
        for piece in _PRETOKEN_RE.findall(text))
    words = {w: c for w, c in words.items() if len(w) > 1}
    merges: list = []
    while len(merges) < n:
        pairs: collections.Counter = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        check(bool(pairs), f"BPE training: the text holds {len(merges)} "
              f"merges, fewer than {n}")
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged: dict = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            if len(out) > 1:
                merged[tuple(out)] = merged.get(tuple(out), 0) + c
        words = merged
    return merges


def _write_tokenizer(path: str) -> int:
    """A llama3-shaped tokenizer.json: the 256 byte symbols, BPE_MERGES
    merges trained on this file's docstring and the burst's texts, and
    llama3's 256 specials at 128000-128255 (vocab 128256). Returns the
    merge count."""
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    from p2p_llm_chat_tpu_torch.tokenizer import _byte_to_unicode
    b2u = _byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = _bpe_merges(__doc__ + SUGGEST_PREFIX + LONG_PROMPT, BPE_MERGES)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    names = {i: t for t, i in LLAMA3_SPECIALS.items()}
    reserved = iter(range(256))
    added = []
    for i in range(128000, 128256):
        content = names.get(i) or f"<|reserved_special_token_{next(reserved)}|>"
        added.append({"id": i, "content": content, "special": True,
                      "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": "1.0", "added_tokens": added,
                   "model": {"type": "BPE", "vocab": vocab,
                             "merges": [f"{a} {b}" for a, b in merges]}},
                  f, ensure_ascii=False)
    return len(merges)


def _hf_config(cfg) -> dict:
    """The HF config.json of a port config (llama or Mixtral)."""
    out = {"architectures": ["MixtralForCausalLM" if cfg.is_moe
                             else "LlamaForCausalLM"],
           "_name_or_path": cfg.name, "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden_size,
           "intermediate_size": cfg.intermediate_size,
           "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": cfg.num_heads,
           "num_key_value_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim,
           "max_position_embeddings": cfg.max_seq_len,
           "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
           "tie_word_embeddings": cfg.tie_embeddings,
           "bos_token_id": cfg.bos_token_id,
           "eos_token_id": list(cfg.eos_token_ids),
           "torch_dtype": "bfloat16"}
    rs = cfg.rope_scaling
    if rs is not None:
        out["rope_scaling"] = {
            "rope_type": "llama3", "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position}
    if cfg.is_moe:
        out.update(num_local_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.num_experts_per_tok)
    return out


def _hf_specs(cfg) -> list:
    """(HF name, shape, std) of every tensor of ``cfg`` in the order they
    are written; std 0 marks a norm (ones), as the reference's init."""
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    std = H ** -0.5
    out = [("model.embed_tokens.weight", (V, H), 1.0)]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (H,), 0.0),
                (f"{p}.self_attn.q_proj.weight", (cfg.q_dim, H), std),
                (f"{p}.self_attn.k_proj.weight", (cfg.kv_dim, H), std),
                (f"{p}.self_attn.v_proj.weight", (cfg.kv_dim, H), std),
                (f"{p}.self_attn.o_proj.weight", (H, cfg.q_dim), std),
                (f"{p}.post_attention_layernorm.weight", (H,), 0.0)]
        if cfg.is_moe:
            m = f"{p}.block_sparse_moe"
            out.append((f"{m}.gate.weight", (cfg.num_experts, H), std))
            for e in range(cfg.num_experts):
                out += [(f"{m}.experts.{e}.w1.weight", (F, H), std),
                        (f"{m}.experts.{e}.w3.weight", (F, H), std),
                        (f"{m}.experts.{e}.w2.weight", (H, F), std)]
        else:
            out += [(f"{p}.mlp.gate_proj.weight", (F, H), std),
                    (f"{p}.mlp.up_proj.weight", (F, H), std),
                    (f"{p}.mlp.down_proj.weight", (H, F), std)]
    out.append(("model.norm.weight", (H,), 0.0))
    if not cfg.tie_embeddings:
        out.append(("lm_head.weight", (V, H), std))
    return out


class _Ckpt:
    """A checkpoint directory written here: ``cfg``'s tensors as bf16,
    each drawn on the card from its own seeded generator, so any of them
    can be drawn again for the checks (:meth:`tensor`)."""

    def __init__(self, d: str, cfg) -> None:
        self.dir, self.cfg = d, cfg
        self.specs = _hf_specs(cfg)
        self.index = {name: i for i, (name, _, _) in enumerate(self.specs)}

    def tensor(self, name: str):
        """The bf16 ``[out, in]`` tensor ``name`` on the card."""
        import torch
        i = self.index[name]
        _, shape, std = self.specs[i]
        if std == 0.0:
            return torch.ones(shape, dtype=torch.bfloat16, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(CKPT_SEED * 1_000_003
                                                       + i)
        return (torch.randn(shape, generator=g, device="cuda")
                * std).to(torch.bfloat16)

    def write(self, tokenizer: bool = True) -> dict:
        """config.json, the shards (at most SHARD_BYTES each, in the specs'
        order) and their index, and the tokenizer; returns the walls."""
        import struct
        import torch
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, "config.json"), "w") as f:
            json.dump(_hf_config(self.cfg), f)
        shards, cur, size = [], [], 0
        for name, shape, _ in self.specs:
            n = 2 * math.prod(shape)
            if cur and size + n > SHARD_BYTES:
                shards.append(cur)
                cur, size = [], 0
            cur.append(name)
            size += n
        shards.append(cur)
        weight_map, total, gen_s, write_s = {}, 0, 0.0, 0.0
        for k, names in enumerate(shards):
            fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
            t0 = time.monotonic()
            host = [(n, self.tensor(n).cpu()) for n in names]
            t1 = time.monotonic()
            header, off = {}, 0
            for n, t in host:
                nb = 2 * t.numel()
                header[n] = {"dtype": "BF16", "shape": list(t.shape),
                             "data_offsets": [off, off + nb]}
                off += nb
            raw = json.dumps(header).encode()
            raw += b" " * (-len(raw) % 8)
            with open(os.path.join(self.dir, fname), "wb") as f:
                f.write(struct.pack("<Q", len(raw)))
                f.write(raw)
                for _, t in host:
                    f.write(t.view(torch.int16).numpy().reshape(-1))
                f.flush()
                os.fsync(f.fileno())
            del host
            gen_s += t1 - t0
            write_s += time.monotonic() - t1
            total += off
            weight_map.update({n: fname for n in names})
        with open(os.path.join(self.dir, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f)
        merges = None
        t0 = time.monotonic()
        if tokenizer:
            merges = _write_tokenizer(os.path.join(self.dir,
                                                   "tokenizer.json"))
        return {"bytes": total, "shards": len(shards), "gen_s": gen_s,
                "write_s": write_s, "merges": merges,
                "train_s": time.monotonic() - t0}


# One temporary root for the phases' checkpoints; main removes it.
_CKPT_ROOT: dict = {}


def _ckpt_root() -> str:
    import tempfile
    if "dir" not in _CKPT_ROOT:
        _CKPT_ROOT["dir"] = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    return _CKPT_ROOT["dir"]


def _drop_ckpts() -> None:
    import shutil
    d = _CKPT_ROOT.pop("dir", None)
    if d is not None:
        shutil.rmtree(d, ignore_errors=True)


def _llama_ckpt() -> _Ckpt:
    """The llama3.1-8b directory at full width and depth (the depth is cut
    only when the temporary directory cannot hold it), written once for
    server_ckpt and server_multi."""
    import shutil
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    if "llama" in _CKPT_ROOT:
        return _CKPT_ROOT["llama"]
    root = _ckpt_root()
    cfg = get_config("llama3.1-8b")
    cfg = cfg.with_(name="llama3.1-8b-seeded",
                    eos_token_ids=(128001, 128009))
    free = shutil.disk_usage(root).free
    need = 2 * sum(math.prod(s) for _, s, _ in _hf_specs(cfg))
    print(f"checkpoint: {free / 1e9:.1f} GB free in {root}; llama3.1-8b "
          f"needs {need / 1e9:.2f} GB", flush=True)
    if free < need + 8e9:
        per_layer = 2 * sum(math.prod(s) for n, s, _ in _hf_specs(cfg)
                            if n.startswith("model.layers.0."))
        L = max(2, int((free - 8e9 - (need - cfg.num_layers * per_layer))
                       // per_layer))
        print(f"checkpoint: DEPTH CUT to {L} of {cfg.num_layers} layers "
              "(disk)", flush=True)
        cfg = cfg.with_(num_layers=L)
    ck = _Ckpt(os.path.join(root, "llama3.1-8b"), cfg)
    w = ck.write()
    print(f"checkpoint llama3.1-8b: {w['bytes'] / 1e9:.3f} GB in "
          f"{w['shards']} shards: drawn on the card and read back "
          f"{w['gen_s']:.2f} s, written (fsync) {w['write_s']:.2f} s = "
          f"{w['bytes'] / 1e9 / w['write_s']:.2f} GB/s; BPE tokenizer "
          f"{w['merges']} merges trained in {w['train_s']:.2f} s",
          flush=True)
    _CKPT_ROOT["llama"] = ck
    return ck


def _record(results: dict, label: str, launches: dict) -> None:
    for name, n in launches.items():
        rec = results.get(name)
        if n and rec is not None:
            rec.setdefault("launches_by_path", {})[label] = n
            rec["launches"] = rec.get("launches", 0) + n


def _bits(t):
    import torch
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_bits(label: str, got, want) -> None:
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    ok = torch.equal(_bits(got), _bits(want))
    check(ok, f"{label}: not bitwise equal")


def _fused_layer(ck: _Ckpt, li: int) -> dict:
    """Layer ``li``'s fused ``[in, out]`` bf16 weights drawn again on the
    card (llama: wqkv, wo, wgu, w_down)."""
    import torch
    p = f"model.layers.{li}"
    t = lambda n: ck.tensor(f"{p}.{n}.weight").T  # noqa: E731
    return {"wqkv": torch.cat([t("self_attn.q_proj"), t("self_attn.k_proj"),
                               t("self_attn.v_proj")], dim=1),
            "wo": t("self_attn.o_proj").contiguous(),
            "wgu": torch.cat([t("mlp.gate_proj"), t("mlp.up_proj")], dim=1),
            "w_down": t("mlp.down_proj").contiguous()}


def _check_tree_on_card(label: str, ck: _Ckpt, params, quant: str) -> None:
    """Every layer and the head of a served quantized tree bitwise equal
    to the port's quantize (int8) or quantize4 (int4) of the same bf16
    weights drawn again on the card, fused; the embedding and the norms
    equal to the shards' bits."""
    from p2p_llm_chat_tpu_torch.models.quant import _quantize_leaf
    layers = params["layers"]
    for li in range(ck.cfg.num_layers):
        for name, w in _fused_layer(ck, li).items():
            qt = _quantize_leaf(w, quant)
            _same_bits(f"{label} layer {li} {name}.q", layers[name].q[li],
                       qt.q)
            _same_bits(f"{label} layer {li} {name}.s", layers[name].s[li],
                       qt.s)
        for key, n in (("attn_norm", "input_layernorm"),
                       ("mlp_norm", "post_attention_layernorm")):
            _same_bits(f"{label} layer {li} {key}", layers[key][li],
                       ck.tensor(f"model.layers.{li}.{n}.weight"))
    head = _quantize_leaf(ck.tensor("lm_head.weight").T.contiguous(), quant)
    _same_bits(f"{label} lm_head.q", params["lm_head"].q, head.q)
    _same_bits(f"{label} lm_head.s", params["lm_head"].s, head.s)
    _same_bits(f"{label} embed", params["embed"],
               ck.tensor("model.embed_tokens.weight"))


def _numpy_int8(w):
    """The reference's host int8 quantizer restated in numpy (its
    models/weights.py _host_quant8 after _bf16_round; the weight is bf16
    already): IEEE f32 abs-max over the contraction axis / 127,
    round-half-even, clip."""
    import numpy as np
    amax = np.abs(w).max(axis=-2, keepdims=True)
    s = np.where(amax > 0, amax / np.float32(127.0),
                 np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s


def _check_tree_numpy(label: str, ck: _Ckpt, params) -> float:
    """Layers 0 and L - 1 and the lm_head of the served int8 tree bitwise
    equal to the reference's host-numpy arithmetic; returns its wall."""
    import numpy as np
    t0 = time.monotonic()
    L = ck.cfg.num_layers
    for li in sorted({0, L - 1}):
        for name, w in _fused_layer(ck, li).items():
            q, s = _numpy_int8(w.float().cpu().numpy())
            leaf = params["layers"][name]
            check(np.array_equal(leaf.q[li].cpu().numpy(), q)
                  and np.array_equal(leaf.s[li].cpu().numpy().view(np.int32),
                                     s.view(np.int32)),
                  f"{label}: layer {li} {name} differs from the numpy "
                  "quantizer")
    q, s = _numpy_int8(ck.tensor("lm_head.weight").float().cpu().numpy().T)
    check(np.array_equal(params["lm_head"].q.cpu().numpy(), q)
          and np.array_equal(params["lm_head"].s.cpu().numpy().view(np.int32),
                             s.view(np.int32)),
          f"{label}: lm_head differs from the numpy quantizer")
    return time.monotonic() - t0


def _load_line(label: str, st: dict, nbytes: int) -> str:
    layers = st["layers_s"]
    read = sum(r for r, _ in layers)
    quant = [q * 1e3 for _, q in layers]
    return (f"{label}: load {st['total_s']:.2f} s for {nbytes / 1e9:.2f} GB "
            f"= {nbytes / 1e9 / st['total_s']:.2f} GB/s; per layer read + "
            f"upload + transpose {read / len(layers) * 1e3:.1f} ms "
            f"({nbytes / 1e9 / max(read + st['top_s'], 1e-9):.2f} GB/s with "
            f"the top tensors), quantize p50 {_p50(quant):.2f} ms (max "
            f"{max(quant):.2f}); embedding + head {st['top_s'] * 1e3:.0f} ms")


def _wait_ready(label: str, backend, timeout: float = 900.0) -> float:
    t0 = time.monotonic()
    while not backend.ready():
        err = backend.warmup_error
        check(err is None, f"{label}: warmup failed: {err!r}")
        check(time.monotonic() - t0 < timeout, f"{label}: never ready")
        time.sleep(0.05)
    return time.monotonic() - t0


def _burst_readings(label: str, finals: list, burst_s: float,
                    snap: dict) -> None:
    ttfts = [r["prompt_eval_duration"] / 1e6 for r in finals]
    toks = sum(r["eval_count"] for r in finals)
    per_req = [r["eval_count"] / (r["eval_duration"] / 1e9)
               for r in finals if r["eval_duration"] > 0]
    print(f"{label}: TTFT ms by request "
          f"{', '.join(f'{t:.1f}' for t in ttfts)} (prompt tokens "
          f"{', '.join(str(r['prompt_eval_count']) for r in finals)}); "
          f"p50 {_p50(ttfts):.1f}, max {max(ttfts):.1f}; decode {toks} "
          f"tokens in {burst_s:.2f} s = {toks / burst_s:.1f} tok/s "
          f"aggregate, {_p50(per_req):.1f} tok/s per request (p50); "
          f"decode_wall_ms {snap['decode_wall_ms']:.3f}, mean K "
          f"{snap['decode_fused_mean_k']:.3f}", flush=True)


def _prefix_exact(label: str, url: str, sched, tok) -> None:
    """Prefix admission follows the tokenizer's ids: the co-pilot
    template is cached at its ids minus the last, and each prompt below is
    admitted on the prefix path exactly when its ids start with that key
    (a message after the template's blank line, one that adds a newline,
    which merges across the boundary under ``\\s*[\\r\\n]+``, one
    that cuts into the template's last word, whose ids may or may not
    keep the key depending on the merges the tokenizer learned from this
    file's docstring, and one that cuts the template's last two words,
    whose ids cannot)."""
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    key = tuple(tok.encode(SUGGEST_PREFIX, add_bos=True)[:-1])
    check(key in sched._prefix._entries, f"{label}: no prefix entry of the "
          f"template's {len(key)} ids")
    seen = set()
    for prompt in (SUGGEST_PREFIX + "Shall we meet at the café at 10?",
                   SUGGEST_PREFIX + "\nShall we meet?",
                   SUGGEST_PREFIX[:-3] + "x, shall we meet?",
                   SUGGEST_PREFIX[:-22] + "Q: shall we meet?"):
        ids = tok.encode(prompt, add_bos=True)
        want = int(tuple(ids[:len(key)]) == key and len(ids) > len(key))
        admits0 = sched.metrics_snapshot()["serve_prefix_admits_total"]
        rec = json.loads(_post(url + "/api/generate", {
            "prompt": prompt, "stream": False,
            "options": {"num_predict": 4}})[1])
        check(rec["context"][:len(ids)] == ids, f"{label}: served ids")
        got = sched.metrics_snapshot()["serve_prefix_admits_total"] - admits0
        check(got == want, f"{label}: prefix admits {got} for "
              f"{prompt[-24:]!r}; the ids say {want}")
        seen.add(want)
        print(f"{label}: ...{prompt[-24:]!r}: ids start with the "
              f"template's {len(key)}-id key: {bool(want)}; prefix "
              f"admitted: {bool(got)}", flush=True)
    check(seen == {0, 1}, f"{label}: the prompts did not give both a hit "
          "and a miss")


def phase_server_ckpt(results: dict) -> None:
    """A checkpoint directory served: llama3.1-8b (full width and depth,
    bf16 shards of at most 5 GB with their index, llama3 rope scaling,
    a llama3-shaped BPE tokenizer) written here, then ``CKPT_DIR`` at
    ``SERVE_QUANT=int8``: the tree bitwise equal to the port's quantize +
    fuse of the same bf16 weights on the card (every layer, the head) and
    to the reference's numpy arithmetic (layers 0 and 31, the head); the
    usual burst (the chat request a co-pilot message in the llama3
    template) and two greedy reruns, kernels A, B (append mode) and D
    launched and B's pool mode not; the prefix entry hit exactly when the
    ids say so; the tokenizer on its native path, timed against the
    Python path. Then ``SERVE_QUANT=""`` from the same directory: the
    embedding and layer 0 equal to the shards' bits, one greedy request
    (kernels B and D). Then a 2-layer mixtral-8x7b directory loaded at
    int4: expert stacks and router bitwise equal to the port's quantize4
    + fuse on the card."""
    import torch
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    from p2p_llm_chat_tpu_torch.tokenizer import BPETokenizer, ByteTokenizer

    ck = _llama_ckpt()
    L = ck.cfg.num_layers
    label = f"server ckpt llama3.1-8b int8 ({L} layers)"
    os.environ.update(SERVE_BACKEND="torch", CKPT_DIR=ck.dir,
                      LLM_MODEL="llama3.1", SERVE_KV="paged",
                      SERVE_QUANT="int8", SERVE_KV_QUANT="int8",
                      SERVE_SLOTS="8", SERVE_MAX_SEQ="4096",
                      SERVE_DEVICE="cuda", SERVE_PREFILL_CHUNK="256",
                      SERVE_PREFIX="1", PAGED_ATTN_IMPL="gather",
                      SERVE_SPEC="0", SERVE_KV_HOST_GB="0")
    t0 = time.monotonic()
    engine = build_engine_from_env()
    server = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        build_s = time.monotonic() - t0
        warm_s = _wait_ready(label, engine)
        print(f"{label}: CKPT_DIR boot to ready {build_s + warm_s:.1f} s "
              f"(load + engine {build_s:.1f} s, warmup {warm_s:.1f} s); "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
              flush=True)
        print(_load_line(label, engine.load_stats, 2 * sum(
            math.prod(s) for _, s, _ in ck.specs)), flush=True)
        sched = engine.scheduler
        check(sched.config.rope_scaling is not None
              and sched.config.vocab_size == 128256, f"{label}: config "
              f"{sched.config}")
        t1 = time.monotonic()
        _check_tree_on_card(label, ck, sched._params, "int8")
        card_s = time.monotonic() - t1
        np_s = _check_tree_numpy(label, ck, sched._params)
        print(f"{label}: tree bitwise equal to quantize + fuse on the card "
              f"({L} layers, head, embedding, norms; {card_s:.1f} s) and to "
              f"the numpy quantizer (layers 0 and {L - 1}, head; "
              f"{np_s:.1f} s)", flush=True)

        tok = sched.tokenizer
        check(isinstance(tok, BPETokenizer) and tok.native,
              f"{label}: the tokenizer is not the native BPE ({tok!r})")
        slow = BPETokenizer.from_file(os.path.join(ck.dir, "tokenizer.json"),
                                      use_native=False)
        texts = {"long prompt": LONG_PROMPT, "docstring": __doc__}
        for name, text in texts.items():
            ids = tok.encode(text, add_bos=True)
            check(slow.encode(text, add_bos=True) == ids
                  and tok.decode(ids[1:]) == text,
                  f"{label}: native and Python BPE disagree on the {name}")
            ms = {}
            for path, t in (("native", tok), ("python", slow)):
                t.encode(text)
                t2 = time.perf_counter()
                for _ in range(5):
                    t.encode(text)
                ms[path] = (time.perf_counter() - t2) / 5 * 1e3
            print(f"{label}: BPE encode of the {name} ({len(text)} chars): "
                  f"{len(ids)} ids against {len(text.encode()) + 1} byte "
                  f"ids; native {ms['native']:.3f} ms, Python "
                  f"{ms['python']:.3f} ms", flush=True)

        from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
        copilot = [{"role": "user", "content": SUGGEST_PREFIX
                    + "are we still on for lunch tomorrow?"}]
        reqs = _server_reqs(chat=copilot[0]["content"])
        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        answers, burst_s = _burst(server.url, reqs)
        finals = _check_burst(label, reqs, answers)
        ctx = [json.loads(_post(server.url + reqs[0][0],
                                reqs[0][1])[1])["context"]
               for _ in range(2)]
        check(ctx[0] == ctx[1] == finals[0]["context"],
              f"{label}: greedy reruns differ from the burst's answer")
        launches = {n: f.launches for n, f in wrappers.items()}
        print(f"{label}: {len(reqs)} concurrent requests and 2 greedy "
              f"reruns; kernel launches: {launches}", flush=True)
        for name in ("quant_matmul", "paged_attention_append",
                     "prefill_attention"):
            check(launches[name] > 0, f"{label}: {name} never launched")
        check(launches["paged_attention"]
              == launches["paged_attention_verify_append"] == 0,
              f"{label}: kernel B's pool or verify mode launched on the "
              "gather branch with speculation off")
        _record(results, label, launches)
        _burst_readings(label, finals, burst_s, engine.metrics_snapshot())

        chat = engine.render_chat(copilot)
        ids = tok.encode(chat, add_bos=True)
        check(finals[2]["prompt_eval_count"] == len(ids), f"{label}: the "
              f"chat request admitted {finals[2]['prompt_eval_count']} ids, "
              f"its template {len(ids)}")
        rec = json.loads(_post(server.url + "/api/generate", {
            "prompt": chat, "stream": False,
            "options": {"num_predict": 8}})[1])
        for special in ("<|start_header_id|>", "<|end_header_id|>",
                        "<|eot_id|>"):
            check(LLAMA3_SPECIALS[special] in rec["context"],
                  f"{label}: {special} not in the chat template's context")
        print(f"{label}: the co-pilot chat in the llama3 template: "
              f"{len(ids)} prompt ids, header and eot ids in its context",
              flush=True)
        _prefix_exact(label, server.url, sched, tok)
        byte_ids = len(ByteTokenizer(512).encode(LONG_PROMPT, add_bos=True))
        print(f"{label}: the long prompt is {finals[3]['prompt_eval_count']} "
              f"BPE ids ({byte_ids} with the byte tokenizer)", flush=True)
    finally:
        server.stop()
        engine.stop()
        del engine
        _free()

    label = f"server ckpt llama3.1-8b bf16 ({L} layers)"
    os.environ.update(SERVE_QUANT="", SERVE_MAX_SEQ="1024")
    t0 = time.monotonic()
    engine = build_engine_from_env()
    server = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        build_s = time.monotonic() - t0
        warm_s = _wait_ready(label, engine)
        print(f"{label}: CKPT_DIR boot to ready {build_s + warm_s:.1f} s "
              f"(load + fuse + engine {build_s:.1f} s, warmup "
              f"{warm_s:.1f} s)", flush=True)
        params = engine.scheduler._params
        _same_bits(f"{label} embed", params["embed"],
                   ck.tensor("model.embed_tokens.weight"))
        for name, w in _fused_layer(ck, 0).items():
            _same_bits(f"{label} layer 0 {name}", params["layers"][name][0],
                       w.contiguous())
        _same_bits(f"{label} lm_head", params["lm_head"],
                   ck.tensor("lm_head.weight").T.contiguous())
        wrappers = _wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        rec = json.loads(_post(server.url + "/api/generate", {
            "prompt": "Draft a reply to: see you at noon?", "stream": False,
            "options": {"num_predict": 16}})[1])
        launches = {n: f.launches for n, f in wrappers.items()}
        check(rec.get("done") is True and rec["eval_count"] > 0,
              f"{label}: {rec}")
        for name in ("paged_attention_append", "prefill_attention"):
            check(launches[name] > 0, f"{label}: {name} never launched")
        check(launches["quant_matmul"] == launches["quant_matmul4"] == 0,
              f"{label}: a quantized matmul ran on bf16 weights")
        _record(results, label, launches)
        print(f"{label}: embedding, layer 0 and head equal to the shards' "
              f"bits; one greedy request, {rec['eval_count']} tokens, "
              f"TTFT {rec['prompt_eval_duration'] / 1e6:.1f} ms; launches "
              f"{launches}", flush=True)
    finally:
        server.stop()
        engine.stop()
        del engine
        _free()
        for k in ("CKPT_DIR", "LLM_MODEL"):
            os.environ.pop(k, None)
    _moe_ckpt_check()


def _moe_ckpt_check() -> None:
    """A 2-layer mixtral-8x7b directory (full width) written here and
    loaded at int4: every expert's fused gate|up and down, the router,
    the attention and the head bitwise equal to the port's quantize4 (or
    its int8 fallback) + fuse on the card; then the directory is
    removed."""
    import shutil
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.quant import _quantize_leaf
    from p2p_llm_chat_tpu_torch.models.weights import (
        load_checkpoint_quantized)
    label = "checkpoint mixtral-8x7b int4 (2 layers)"
    cfg = get_config("mixtral-8x7b").with_(num_layers=2,
                                           name="mixtral-8x7b-2l")
    ck = _Ckpt(os.path.join(_ckpt_root(), "mixtral"), cfg)
    try:
        w = ck.write(tokenizer=False)
        print(f"{label}: {w['bytes'] / 1e9:.3f} GB in {w['shards']} shards "
              f"written in {w['write_s']:.2f} s = "
              f"{w['bytes'] / 1e9 / w['write_s']:.2f} GB/s", flush=True)
        stats: dict = {}
        params, _ = load_checkpoint_quantized(ck.dir, quant="int4",
                                              device="cuda", stats=stats)
        print(_load_line(label, stats, w["bytes"]), flush=True)
        layers = params["layers"]
        for li in range(2):
            p = f"model.layers.{li}"
            for e in range(cfg.num_experts):
                m = f"{p}.block_sparse_moe.experts.{e}"
                gu = torch.cat([ck.tensor(f"{m}.w1.weight").T,
                                ck.tensor(f"{m}.w3.weight").T], dim=1)
                for name, wt in (("wgu_e", gu), ("w_down", ck.tensor(
                        f"{m}.w2.weight").T.contiguous())):
                    qt = _quantize_leaf(wt, "int4", expert=True)
                    _same_bits(f"{label} layer {li} expert {e} {name}.q",
                               layers[name].q[li, e], qt.q)
                    _same_bits(f"{label} layer {li} expert {e} {name}.s",
                               layers[name].s[li, e], qt.s)
            _same_bits(f"{label} layer {li} router", layers["router"][li],
                       ck.tensor(f"{p}.block_sparse_moe.gate.weight").T
                       .contiguous())
            qkv = torch.cat([ck.tensor(f"{p}.self_attn.{n}_proj.weight").T
                             for n in "qkv"], dim=1)
            qt = _quantize_leaf(qkv, "int4")
            _same_bits(f"{label} layer {li} wqkv.q", layers["wqkv"].q[li],
                       qt.q)
        head = _quantize_leaf(ck.tensor("lm_head.weight").T.contiguous(),
                              "int4")
        _same_bits(f"{label} lm_head.q", params["lm_head"].q, head.q)
        print(f"{label}: expert stacks wgu_e {tuple(layers['wgu_e'].q.shape)}"
              f" and w_down {tuple(layers['w_down'].q.shape)}, router, wqkv "
              "and head bitwise equal to quantize4 + fuse on the card",
              flush=True)
        del params, layers
    finally:
        shutil.rmtree(ck.dir, ignore_errors=True)
        _free()


def phase_server_multi(results: dict) -> None:
    """Two models behind one front: ``CKPT_DIR`` (the llama3.1-8b
    directory, tag ``llama3.1``) and ``SERVE_MODELS=small=llama3.2-1b``
    (random init, seed 1, byte tokenizer), both at ``SERVE_QUANT=int4``,
    int8 pools. /readyz stays 503 until both engines have warmed (one
    after the other); /api/tags and /api/ps list both; /api/show gives 32
    and 16 blocks (an unknown tag the default's); /metrics carries both
    tags' series. A burst to each tag alone (launch counters zeroed:
    kernel C on the 8B, kernels B and D at head_dim 64 on the 1B), then
    both bursts at once from two threads: every greedy answer equal to
    its tag's alone. An /api/embed to ``small`` during a greedy rerun on
    ``llama3.1`` leaves the rerun unchanged."""
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    from p2p_llm_chat_tpu_torch.serve.multi import MultiBackend

    ck = _llama_ckpt()
    label = "server multi"
    os.environ.update(SERVE_BACKEND="torch", CKPT_DIR=ck.dir,
                      LLM_MODEL="llama3.1", SERVE_MODELS="small=llama3.2-1b",
                      SERVE_KV="paged", SERVE_QUANT="int4",
                      SERVE_KV_QUANT="int8", SERVE_SLOTS="8",
                      SERVE_MAX_SEQ="4096", SERVE_DEVICE="cuda",
                      SERVE_PREFILL_CHUNK="256", SERVE_PREFIX="1",
                      PAGED_ATTN_IMPL="gather", SERVE_SPEC="0",
                      SERVE_KV_HOST_GB="0")
    t0 = time.monotonic()
    multi = build_engine_from_env()
    server = OllamaServer(multi, addr="127.0.0.1:0").start()
    try:
        check(isinstance(multi, MultiBackend)
              and multi.models() == ["llama3.1", "small"],
              f"{label}: models {multi.models()}")
        build_s = time.monotonic() - t0
        big, small = multi.backends["llama3.1"], multi.backends["small"]
        states = set()
        while True:
            check(multi.warmup_error is None,
                  f"{label}: warmup failed: {multi.warmup_error!r}")
            check(time.monotonic() - t0 < 900, f"{label}: never ready")
            before = (big.ready(), small.ready())
            code = _status("GET", server.url + "/readyz")[0]
            after = (big.ready(), small.ready())
            states.add((before, code))
            # Readiness only turns on: a 200 is a fault when an engine is
            # still not ready after the call (one that turned ready
            # between the read before and the call is not).
            check(code != 200 or all(after), f"{label}: /readyz 200 with "
                  f"engines ready {before} before the call, {after} after")
            if code == 200 and all(after):
                break
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        check(any(code == 503 and any(b) for b, code in states),
              f"{label}: never saw one engine warm and /readyz 503 "
              f"({states})")
        print(f"{label}: boot to ready {ready_s:.1f} s (loads and init "
              f"{build_s:.1f} s); /readyz 503 while one engine was warm; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
              flush=True)
        print(_load_line(f"{label} llama3.1 int4", big.load_stats, 2 * sum(
            math.prod(s) for _, s, _ in ck.specs)), flush=True)

        url = server.url
        tags = [m["name"] for m in json.loads(
            _get(url + "/api/tags")[1])["models"]]
        ps = [m["name"] for m in json.loads(_get(url + "/api/ps")[1])["models"]]
        blocks = {t: json.loads(_post(url + "/api/show", {"model": t})[1])
                  ["model_info"]["llama.block_count"]
                  for t in ("llama3.1", "small", "no-such-tag")}
        check(tags == ps == ["llama3.1", "small"], f"{label}: tags {tags}, "
              f"ps {ps}")
        check(blocks == {"llama3.1": ck.cfg.num_layers,
                         "small": get_config("llama3.2-1b").num_layers,
                         "no-such-tag": ck.cfg.num_layers},
              f"{label}: /api/show blocks {blocks}")
        metrics = _get(url + "/metrics")[1]
        for tag in ("llama3.1", "small"):
            check(f'serve_kv_free_pages{{model="{tag}"}}' in metrics,
                  f"{label}: no {tag} series on /metrics")

        def reqs_for(tag: str) -> list:
            return [("/api/generate", {"model": tag, "prompt": p,
                                       "stream": s, "options": {
                                           "num_predict": n}})
                    for p, s, n in (("Draft a reply to: see you at noon?",
                                     False, 24),
                                    ("hello there", True, 24),
                                    (LONG_PROMPT, False, 16),
                                    ("stream me", True, 32))]

        wrappers = _wrappers()
        alone, want = {}, {}
        for tag, need in (("llama3.1", ("quant_matmul4",
                                        "paged_attention_append",
                                        "prefill_attention")),
                          ("small", ("quant_matmul4",
                                     "paged_attention_append",
                                     "prefill_attention"))):
            for fn in wrappers.values():
                fn.launches = 0
            reqs = reqs_for(tag)
            answers, burst_s = _burst(url, reqs)
            finals = _check_burst(f"{label} {tag}", reqs, answers)
            launches = {n: f.launches for n, f in wrappers.items()}
            for name in need:
                check(launches[name] > 0, f"{label} {tag}: {name} never "
                      f"launched ({launches})")
            check(launches["quant_matmul"] == launches["paged_attention"]
                  == launches["paged_attention_verify_append"] == 0,
                  f"{label} {tag}: {launches}")
            _record(results, f"{label} {tag} "
                    f"(head_dim {multi.backends[tag].config.head_dim})",
                    launches)
            want[tag] = [r["context"] for r in finals]
            alone[tag] = burst_s
            _burst_readings(f"{label} {tag} alone", finals, burst_s,
                            multi.backends[tag].metrics_snapshot())
            print(f"{label} {tag}: launches {launches}", flush=True)
        got: dict = {}

        def run(tag: str) -> None:
            got[tag] = _burst(url, reqs_for(tag))

        t1 = time.monotonic()
        threads = [threading.Thread(target=run, args=(t,))
                   for t in ("llama3.1", "small")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        both_s = time.monotonic() - t1
        for tag in ("llama3.1", "small"):
            finals = _check_burst(f"{label} {tag} interleaved",
                                  reqs_for(tag), got[tag][0])
            ctxs = [r["context"] for r in finals]
            for i, (g, w) in enumerate(zip(ctxs, want[tag])):
                check(g == w, f"{label} {tag}: request {i}'s greedy answer "
                      "changed when both tags were served at once")
        print(f"{label}: both bursts at once in {both_s:.2f} s (alone: "
              f"llama3.1 {alone['llama3.1']:.2f} s, small "
              f"{alone['small']:.2f} s); every greedy answer equal to its "
              "tag's alone", flush=True)

        emb: dict = {}

        def embed() -> None:
            emb["v"] = _post(url + "/api/embed", {"model": "small",
                                                  "input": EMBED_LONG})

        th = threading.Thread(target=embed)
        th.start()
        rerun = json.loads(_post(url + "/api/generate", reqs_for(
            "llama3.1")[0][1])[1])["context"]
        th.join()
        check(emb["v"][0] == 200, f"{label}: embed {emb['v'][0]}")
        vecs = json.loads(emb["v"][1])["embeddings"]
        H = small.config.hidden_size
        check(len(vecs) == len(EMBED_LONG)
              and all(len(v) == H for v in vecs),
              f"{label}: embed to small: {len(vecs)} vectors")
        check(rerun == want["llama3.1"][0], f"{label}: an embed to small "
              "changed llama3.1's greedy rerun")
        print(f"{label}: /api/embed to small ({len(vecs)} x {H}) during a "
              "llama3.1 greedy rerun: the rerun unchanged", flush=True)
    finally:
        server.stop()
        multi.stop()
        del multi
        for k in ("CKPT_DIR", "LLM_MODEL", "SERVE_MODELS"):
            os.environ.pop(k, None)
        _free()


# -- phase 11: the lockstep multi-process plane -------------------------------

MH_REQS = [  # (prompt, options): three greedy rows, one seeded sampled row
    ("The co-pilot drafts a reply: ", {"num_predict": 16}),
    ("are we still on for lunch tomorrow?", {"num_predict": 16}),
    ("0123456789:;<=>?", {"num_predict": 16}),
    ("seeded: see you at noon", {"num_predict": 16, "temperature": 0.8,
                                 "top_p": 0.9, "seed": 42})]
MH_LEG_S = 120.0     # each leg's limit


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mh_env(n: int, pid: int, port: int, **kw) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)), SERVE_BACKEND="torch", SERVE_DEVICE="cuda",
        SERVE_COORDINATOR=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(n),
        JAX_PROCESS_ID=str(pid), SERVE_MAX_SEQ="512", **kw)
    for k in ("SERVE_KV", "SERVE_QUANT", "SERVE_TP", "CKPT_DIR",
              "SERVE_MODELS", "SERVE_SPEC", "SERVE_DRAFT"):
        if k not in kw:
            env.pop(k, None)
    return env


def _mh_spawn(n: int, logdir: str, leg: str, cmd: list, **kw) -> list:
    port = _free_port()
    procs = []
    for pid in range(n):
        log = open(os.path.join(logdir, f"{leg}{pid}.log"), "w")
        procs.append((subprocess.Popen(
            cmd, env=_mh_env(n, pid, port, **kw), stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _mh_wait(procs, deadline: float, label: str) -> None:
    """Every rank's exit before ``deadline``; rc 0 each."""
    for i, (p, _) in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"{label}: rank {i} still running at its "
                               f"leg's limit; its log's tail:\n"
                               f"{_mh_tail(procs, i)}") from None
        check(p.returncode == 0, f"{label}: rank {i} exited "
              f"{p.returncode}; its log's tail:\n{_mh_tail(procs, i)}")


def _mh_kill(procs) -> None:
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        log.close()


def _mh_summaries(logdir: str, leg: str, n: int) -> list:
    out = []
    for pid in range(n):
        text = open(os.path.join(logdir, f"{leg}{pid}.log")).read()
        mark = "summary: "
        check(mark in text, f"{leg}: rank {pid} logged no summary; log "
              f"tail:\n{text[-3000:]}")
        out.append(json.loads(text.split(mark, 1)[1].splitlines()[0]))
    return out


def _mh_tail(procs, i: int) -> str:
    log = procs[i][1]
    log.flush()
    with open(log.name) as f:
        return f.read()[-3000:]


def _mh_up(url: str, procs, deadline: float, label: str) -> None:
    while time.monotonic() < deadline:
        for i, (p, _) in enumerate(procs):
            check(p.poll() is None, f"{label}: rank {i} exited "
                  f"{p.returncode} before the front came up; its log's "
                  f"tail:\n{_mh_tail(procs, i)}")
        try:
            _get(url + "/api/version", timeout=5)
            return
        except OSError:
            time.sleep(0.5)
    raise SmokeFailure(f"{label}: the front never came up")


def _mh_line(label: str, sums: list) -> dict:
    """Print a leg's round / step / collective times (each rank's p50)
    beside the card, and return them."""
    keys = ("round_ms_p50", "step_ms_p50", "collective_ms_p50")
    print(f"  {label}: " + "; ".join(
        f"rank {s['rank']} round {s['round_ms_p50']:.1f} ms, decode step "
        f"{s['step_ms_p50']:.2f} ms, of it in collectives "
        f"{s['collective_ms_p50']:.2f} ms ({s['steps']} steps, "
        f"{s['rounds']} rounds; backend {s['backend']}; peak "
        f"{s['peak_mb'] / 1024:.1f} GB)" for s in sums)
        + f" [card: {card_line()}]", flush=True)
    return {f"rank{s['rank']}": {k: round(s[k], 3) for k in keys}
            | {"backend": s["backend"], "peak_gb": round(s["peak_mb"] / 1024,
                                                         2)}
            for s in sums}


def _mh_rank_main() -> int:
    """One rank of the tp = 2 parity leg (``chip_smoke.py --mh-rank``):
    its shard of llama3.1-8b's quote weights drawn on its card a layer at
    a time, the plane's engine; the leader runs
    MH_REQS and writes the texts and the first round's logits. Every
    rank writes a CRC of each round's gathered logits, its timings,
    launches, peak memory and backend to MH_OUT."""
    import zlib
    import numpy as np
    import torch
    from p2p_llm_chat_tpu_torch import ops
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.parallel.distributed import (
        init_distributed, multihost_mesh, rank_device)
    from p2p_llm_chat_tpu_torch.parallel.mesh import MeshConfig
    from p2p_llm_chat_tpu_torch.serve.multihost import MultihostEngine
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    init_distributed()
    dev = rank_device()
    torch.cuda.set_device(dev)
    world = torch.distributed.get_world_size()
    mesh = multihost_mesh(MeshConfig(tp=world), dev)
    cfg = get_config("llama3.1-8b")
    # This rank's shard drawn a layer at a time (models/synth.quote_params
    # under the mesh), never the whole bf16 tree.
    params = quote_params(cfg, seed=0, quant="", device=dev, mesh=mesh)
    eng = MultihostEngine(params, cfg, ByteTokenizer(cfg.vocab_size), mesh,
                          max_seq=512)
    crcs, first = [], []
    gather = eng._gather_rows

    def hooked(x):
        a = gather(x)
        crcs.append(zlib.crc32(a.tobytes()))
        if not first:
            first.append(a)
        return a
    eng._gather_rows = hooked
    out = os.environ["MH_OUT"]
    res = {"rank": mesh.rank}
    if eng.is_follower:
        eng.follower_loop()
    else:
        res["texts"] = _mh_run(eng)
        eng.stop()
        np.save(out + ".logits.npy", first[0])
    res.update(crcs=crcs, backend=mesh.backend, **eng.timings(),
               peak_mb=torch.cuda.max_memory_allocated(dev) / 2**20,
               launches={k: w.launches for k, w in ops.wrappers().items()})
    with open(out, "w") as f:
        json.dump(res, f)
    eng.close()
    return 0


# The tp2_engine leg (SERVE_TP in the continuous-batching engine): four
# concurrent 16-token requests — the co-pilot's (a prefix hit), the
# 1,500-byte long prompt (chunked: 1501 ids in a 2048 bucket, 8 chunks of
# 256), a short one and a seeded sampled one; the first three are greedy
# and make the parity part's prompts.
TP_LEG_S = 110.0
# The normal-entry part's models on the same ranks (SERVE_MODELS), the
# first the default, and the burst's requests the second tag also gets.
TP_MODELS = {"llama": "llama3.1-8b", "small": "llama3.2-1b"}
TP_SMALL_REQS = ("co-pilot", "short")
TP_ENGINE = dict(num_slots=4, max_seq=2048, page_size=64, kv_mode="paged",
                 kv_quant=True, prefix_cache=True, prefill_chunk=256,
                 decode_fuse_max=4, attn_impl="gather", kv_host_gb=8.0,
                 kv_idle_s=600.0)
# The tier's second turn: a follow-up to the 1,500-byte first turn.
TP_TIER_SUFFIX = " So, are we still on for lunch tomorrow at noon?"


def _tp_reqs() -> list:
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    return [("co-pilot", SUGGEST_PREFIX + "are we still on for lunch "
             "tomorrow?", {"num_predict": 16}),
            ("long", LONG_PROMPT, {"num_predict": 16}),
            ("short", "hello there", {"num_predict": 16}),
            ("seeded", "see you at noon?", {"num_predict": 16,
                                            "temperature": 0.8,
                                            "top_p": 0.9, "seed": 11})]


def _tp_env(**kw) -> dict:
    """This process's env without any serving setting an earlier phase
    left in it, plus ``kw``."""
    drop = ("SERVE_", "PAGED_", "JAX_COORDINATOR", "JAX_NUM_PROCESSES",
            "JAX_PROCESS_ID", "CKPT_DIR", "MODEL_CONFIG", "LLM_MODEL")
    env = {k: v for k, v in os.environ.items() if not k.startswith(drop)}
    env.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               SERVE_BACKEND="torch", SERVE_DEVICE="cuda", **kw)
    return env


def _tp_contexts(eng) -> tuple[list, list]:
    """The leg's greedy prompts through ``eng`` one after another (the
    same admission shapes at tp = 1 and tp = 2): each context, and each
    TTFT in ms."""
    from p2p_llm_chat_tpu_torch.serve.backend import (
        GenerateOptions, GenerateRequest, RequestStats, collect)
    out, ttft = [], []
    for _, prompt, opts in _tp_reqs()[:3]:
        stats = RequestStats()
        collect(eng, GenerateRequest(prompt=prompt, model="x",
                                     options=GenerateOptions.from_ollama(
                                         opts)), stats)
        out.append(list(stats.context))
        ttft.append(stats.ttft_s * 1e3)
    return out, ttft


def _tp_turn(eng, prompt: str, ctx=()) -> tuple:
    """One greedy 8-token turn of a conversation through ``eng``: its
    context and TTFT in ms."""
    from p2p_llm_chat_tpu_torch.serve.backend import (
        GenerateOptions, GenerateRequest, RequestStats, collect)
    stats = RequestStats()
    collect(eng, GenerateRequest(prompt=prompt, model="x",
                                 context=tuple(ctx),
                                 options=GenerateOptions.from_ollama(
                                     {"num_predict": 8})), stats)
    return list(stats.context), stats.ttft_s * 1e3


def _tp_tier(eng, path: str, ctx1: list, cold_ms: float) -> dict:
    """The KV tier at tp = 2 on the leader (``--tp-rank``): the long
    parity prompt's conversation (``ctx1``: 1502 ids admitted cold in
    ``cold_ms``, 8 chunks of the 2048 bucket, as its follow-up's 1557
    would take), retained under its head key, is parked alone (the park
    op: each rank gathers its pages, the kv heads all-gathered over tp,
    the leader's readback) and exported to ``path``; then the follow-up
    wakes (the leader's payload broadcast over tp, each rank scattering
    its heads, the suffix through kernel B's verify mode). Readings: the
    park wall (its handshake with the loop included), the payload's bytes
    per parked token, the woken and the cold TTFT and
    ``kv_wake_p50_ms``."""
    from p2p_llm_chat_tpu_torch.serve import kv_tier
    sched = eng.scheduler
    key = kv_tier.head_key(ctx1)
    deadline = time.monotonic() + 30
    while key not in sched.session_list():
        check(time.monotonic() < deadline, "tp2 tier: the first turn was "
              "never retained")
        time.sleep(0.01)
    check(not sched.session_list()[key]["parked"], "tp2 tier: the session "
          "was parked before its timed park")
    t0 = time.perf_counter()
    sched.park_all(key=key)
    park_ms = (time.perf_counter() - t0) * 1e3
    check(sched.session_list()[key]["parked"], "tp2 tier: not parked")
    data = eng.session_export(key)
    with open(path, "wb") as f:
        f.write(data)
    sess = kv_tier.deserialize_session(data)
    nbytes = sum(kv_tier.tensor_nbytes(a) for a in sess.host[0]
                 if a is not None)
    waked = eng.metrics_snapshot()["kv_waked_total"]
    ctx2, wake_ms = _tp_turn(eng, TP_TIER_SUFFIX, ctx1)
    m = eng.metrics_snapshot()
    check(m["kv_waked_total"] == waked + 1, f"tp2 tier: the follow-up did "
          f"not wake ({waked} -> {m['kv_waked_total']} wakes)")
    return dict(context2=ctx2, park_ms=park_ms,
                payload_bytes=nbytes, tokens=sess.length,
                slots=sess.host[1] * sched.page_size, wake_ttft_ms=wake_ms,
                cold_ttft_ms=cold_ms, kv_wake_p50_ms=m["kv_wake_p50_ms"],
                kv_waked_total=m["kv_waked_total"])


def _tp_rank_main() -> int:
    """One rank of the tp2_engine leg's parity part (``chip_smoke.py
    --tp-rank``): its shard of llama3.1-8b's int8 quote weights drawn on
    its card a layer at a time, the engine at tp = 2 (TP_ENGINE); the
    leader warms it (the co-pilot prefix registered), runs the greedy
    prompts and the KV tier's conversation (:func:`_tp_tier`); every
    rank writes its digests, launches and peak to MH_OUT and logs its
    summary line."""
    import torch
    from p2p_llm_chat_tpu_torch import ops
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.parallel.distributed import (
        init_distributed, multihost_mesh, rank_device)
    from p2p_llm_chat_tpu_torch.parallel.mesh import MeshConfig
    from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    init_distributed(join_timeout_s=120)
    dev = rank_device()
    torch.cuda.set_device(dev)
    mesh = multihost_mesh(MeshConfig(tp=2), dev)
    cfg = get_config("llama3.1-8b")
    params = quote_params(cfg, seed=0, quant="int8", device=dev, mesh=mesh)
    eng = TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), mesh=mesh,
                      device=dev, **TP_ENGINE)
    res = {"rank": mesh.rank}
    if eng.is_follower:
        eng.follower_loop()
    else:
        eng.warmup((256,), background=False)
        res["contexts"], ttft = _tp_contexts(eng)
        res["tier"] = _tp_tier(eng, os.environ["MH_OUT"] + ".session",
                               res["contexts"][1], ttft[1])
        eng.stop()
    res.update(digests=eng.scheduler.digests,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
               launches={k: w.launches for k, w in ops.wrappers().items()})
    with open(os.environ["MH_OUT"], "w") as f:
        json.dump(res, f)
    eng.close()
    return 0


def _tp_tag_summaries(path: str, label: str) -> tuple[dict, dict]:
    """The ranks' lines of a multi-model plane in one log
    (serve/multi.MultiBackend.close): ({(rank, tag): summary}, {rank:
    launches})."""
    text = open(path).read()
    sums = {(int(r), tag): json.loads(body) for r, tag, body in re.findall(
        r"tp rank (\d+) model (\S+) summary: (\{.*\})", text)}
    launches = {int(r): json.loads(body) for r, body in re.findall(
        r"tp rank (\d+) launches: (\{.*\})", text)}
    want = {(r, t) for r in (0, 1) for t in TP_MODELS}
    check(set(sums) == want and sorted(launches) == [0, 1], f"{label}: "
          f"summaries of {sorted(sums)}, launches of ranks "
          f"{sorted(launches)}; log tail:\n{text[-3000:]}")
    return sums, launches


def _tp_labelled(m: dict, name: str, tag: str) -> float:
    return float(m[f'{name}{{model="{tag}"}}'])


def _tp2_engine_leg(results: dict, logdir: str) -> dict:
    """SERVE_TP = 2 in the continuous-batching engine (serve/tp.py), two
    ranks on the one card over gloo, under TP_LEG_S:

    - the normal entry with two models on the same ranks,
      ``SERVE_TP=2 SERVE_MODELS=llama=llama3.1-8b,small=llama3.2-1b
      SERVE_KV=paged SERVE_QUANT=int8 SERVE_KV_QUANT=int8 python -m
      p2p_llm_chat_tpu_torch.serve`` (random weights, full width and
      depth, prefix on, chunk 256, fuse 4, 4 slots, max_seq 2048, the byte
      tokenizer; one op stream for both engines, each op naming its
      engine; the leader starts its follower): ``/readyz`` 503 until both
      engines have warmed (each one's warmup probe on ``/metrics`` once it
      answers 200), ``/api/tags`` listing both; the four requests of
      :func:`_tp_reqs` to ``llama`` and its co-pilot and short ones to
      ``small`` at once (each 200 and non-empty); then each tag's greedy
      requests again, that tag alone, each answer equal to the burst's;
      ``/metrics`` (a prefix admit, >= 5 prefill chunks, fused ticks on
      ``llama``), one ``/api/embed``, SIGTERM -> rc 0 within 30 s; from
      each rank's lines, per tag the token digests equal on both ranks and
      decode ticks run (``small``'s run kernel B at head dim 64,
      ``llama``'s at 128), kernels A, B (append) and D launched, the peak;
    - the KV tier on (``SERVE_KV_HOST_GB``): a multi-model front answers
      the session routes 501, as the reference's, so the idle sweep parks
      (``SERVE_KV_IDLE_S=1``): a ``llama`` conversation whose first turn
      parks with every other ``llama`` session before its second turn,
      which wakes (``kv_waked_total`` >= 1);
    - parity: the greedy prompts on int8 quote weights through two
      ``--tp-rank`` ranks, then (after they exit) a tp = 1 engine on the
      same weights: equal contexts, or parting on a near tie as
      :func:`_against_cold` judges it; the ranks' tier conversation
      (:func:`_tp_tier`: the long prompt's session parked, exported and
      its follow-up woken, timed)
      and its session imported at tp = 1, woken to tp = 2's reply token
      for token."""
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    leg = "tp2_engine"
    t_leg = time.monotonic()
    deadline = t_leg + TP_LEG_S
    sport = _free_port()
    url = f"http://127.0.0.1:{sport}"
    path = os.path.join(logdir, f"{leg}.log")
    log = open(path, "w")
    procs = [(subprocess.Popen(
        [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"],
        env=_tp_env(SERVE_TP="2", SERVE_MODELS=",".join(
                        f"{t}={c}" for t, c in TP_MODELS.items()),
                    SERVE_KV="paged", SERVE_QUANT="int8",
                    SERVE_KV_QUANT="int8", SERVE_PREFIX="1",
                    SERVE_PREFILL_CHUNK="256", SERVE_FUSE="4",
                    SERVE_MAX_SEQ="2048", SERVE_SLOTS="4",
                    SERVE_WARMUP="256", SERVE_KV_HOST_GB="4",
                    SERVE_KV_IDLE_S="1", SERVE_ADDR=f"127.0.0.1:{sport}"),
        stdout=log, stderr=subprocess.STDOUT), log)]
    tags = list(TP_MODELS)
    reqs = [("llama", r) for r in _tp_reqs()] + [
        ("small", r) for r in _tp_reqs() if r[0] in TP_SMALL_REQS]
    try:
        _mh_up(url, procs, deadline, leg)
        statuses = []
        while True:
            try:
                statuses.append(_status("GET", url + "/readyz",
                                        timeout=5)[0])
            except OSError:
                pass
            if statuses and statuses[-1] == 200:
                break
            check(procs[0][0].poll() is None and time.monotonic() < deadline,
                  f"{leg}: never ready; log tail:\n{_mh_tail(procs, 0)}")
            time.sleep(0.5)
        t_ready = time.monotonic() - t_leg
        m = _metrics(url)
        warm = {t: _tp_labelled(m, "decode_device_ms", t) for t in tags}
        check(503 in statuses and all(v > 0 for v in warm.values()),
              f"{leg}: /readyz answered {statuses} before 200, the "
              f"engines' warmup probes {warm}")
        listed = [x["name"] for x in json.loads(
            _get(url + "/api/tags")[1])["models"]]
        check(listed == tags, f"{leg}: /api/tags lists {listed}")

        def body_of(tag: str, p: str, o: dict) -> tuple:
            return ("/api/generate", {"model": tag, "prompt": p,
                                      "stream": False, "options": o})

        def checked(label: str, ans) -> dict:
            check(not isinstance(ans, Exception) and ans[0] == 200,
                  f"{leg}: {label} answered {ans!r}")
            # Random weights over the byte tokenizer mostly sample ids
            # past its 256 bytes, which decode to no text: a non-empty
            # answer is one with generated tokens in its context.
            body = json.loads(ans[1])
            check(body["done"] and body["eval_count"] >= 1
                  and len(body["context"]) == body["prompt_eval_count"]
                  + body["eval_count"], f"{leg}: {label} empty: {body}")
            return body
        answers, burst_s = _burst(url, [body_of(t, p, o)
                                        for t, (_, p, o) in reqs])
        ttft, burst_ctx = {}, {}
        for (tag, (label, _, o)), ans in zip(reqs, answers):
            body = checked(f"{tag} {label}", ans)
            ttft[f"{tag} {label}"] = body["prompt_eval_duration"] / 1e6
            if "seed" not in o:
                burst_ctx[(tag, label)] = body["context"]
        # Each tag's greedy requests again, that tag alone.
        for tag in tags:
            greedy = [(t, r) for t, r in reqs
                      if t == tag and "seed" not in r[2]]
            again, _ = _burst(url, [body_of(t, p, o)
                                    for t, (_, p, o) in greedy])
            for (t, (label, _, _)), ans in zip(greedy, again):
                ctx = checked(f"{t} {label} alone", ans)["context"]
                check(ctx == burst_ctx[(t, label)], f"{leg}: {t} {label} "
                      "alone parts from its answer in the two-tag burst "
                      "at context position "
                      f"{_first_diff(ctx, burst_ctx[(t, label)])}")
        m = _metrics(url)
        admits = _tp_labelled(m, "serve_prefix_admits_total", "llama")
        chunks = _tp_labelled(m, "prefill_chunks_total", "llama")
        fused = _tp_labelled(m, "decode_fused_ticks_total", "llama")
        check(admits >= 1 and chunks >= 5 and fused > 0, f"{leg}: prefix "
              f"admits {admits}, prefill chunks {chunks}, fused ticks {fused}")
        st, body = _post(url + "/api/embed", {"model": "llama",
                                              "input": ["see you at noon"]})
        check(st == 200 and len(json.loads(body)["embeddings"][0])
              == get_config(TP_MODELS["llama"]).hidden_size, f"{leg}: embed")
        # The KV tier: a conversation (the default tag's) whose first turn
        # the idle sweep parks before its second turn wakes it.
        rec = _tier_gen(leg, url, "remind me what we said about lunch",
                        "tp-conv", n=4)
        while True:
            m = _metrics(url)
            if (_tp_labelled(m, "kv_resident_sessions", "llama") == 0
                    and _tp_labelled(m, "kv_parked_sessions", "llama") >= 1):
                break
            check(time.monotonic() < deadline, f"{leg}: the idle sweep "
                  "never parked the first turn's session")
            time.sleep(0.2)
        waked0 = _tp_labelled(m, "kv_waked_total", "llama")
        _tier_gen(leg, url, " and dinner?", "tp-conv", rec["context"], n=4)
        tier_m = _metrics(url)
        waked = _tp_labelled(tier_m, "kv_waked_total", "llama")
        parked = _tp_labelled(tier_m, "kv_parked_total", "llama")
        check(waked >= waked0 + 1 and parked >= 1, f"{leg}: the second turn "
              f"did not wake a parked session (kv_waked_total {waked0} -> "
              f"{waked}, kv_parked_total {parked})")
        t_stop = time.monotonic()
        procs[0][0].send_signal(15)
        _mh_wait(procs, time.monotonic() + 30, f"{leg} after SIGTERM")
        stop_s = time.monotonic() - t_stop
    finally:
        _mh_kill(procs)
    sums, launches = _tp_tag_summaries(path, leg)
    for rank, counts in launches.items():
        for k in ("quant_matmul", "paged_attention_append",
                  "prefill_attention"):
            check(counts[k] > 0, f"{leg}: rank {rank} never launched {k}")
        _record_launches(results, f"server_multihost {leg} rank {rank}",
                         counts)
    for (rank, tag), s in sums.items():
        check(s["digests_equal"] is True and s["backend"] == "gloo"
              and s["steps"] >= 1, f"{leg}: rank {rank} {tag}: digests "
              f"equal {s['digests_equal']}, backend {s['backend']}, "
              f"{s['steps']} ticks")
    for tag in tags:
        check(sums[(0, tag)]["digest"] == sums[(1, tag)]["digest"],
              f"{leg}: {tag} digests {sums[(0, tag)]['digest']} / "
              f"{sums[(1, tag)]['digest']}")
    t_env = time.monotonic() - t_leg
    print(f"server_multihost {leg}: SERVE_TP=2 SERVE_MODELS="
          + ",".join(f"{t}={c}" for t, c in TP_MODELS.items())
          + f" through the normal entry, /readyz 503 until both warmed "
          f"(ready in {t_ready:.1f} s), {len(reqs)} requests of both tags "
          f"in {burst_s:.2f} s (TTFT "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in ttft.items())
          + "), each tag's greedy answers equal alone, prefix admits "
          f"{admits:.0f}, prefill chunks {chunks:.0f}, fused ticks "
          f"{fused:.0f} on llama, embed answered, a parked conversation's "
          f"second turn woken (kv_waked_total {waked:.0f}), SIGTERM -> rc 0 "
          f"in {stop_s:.1f} s; "
          + "; ".join(f"rank {r} {t} ({get_config(TP_MODELS[t]).head_dim}"
                      f"-wide heads): decode step p50 {s['step_ms_p50']:.2f}"
                      f" ms, of it in collectives "
                      f"{s['collective_ms_p50']:.2f} ms ({s['steps']} "
                      f"ticks), digest {s['digest']}"
                      for (r, t), s in sorted(sums.items()))
          + "; " + "; ".join(
              f"rank {r}: peak {sums[(r, tags[0])]['peak_gb']:.1f} GB, "
              f"launches A {c['quant_matmul']} B "
              f"{c['paged_attention_append']} D {c['prefill_attention']}"
              for r, c in sorted(launches.items()))
          + f"; {t_env:.0f} s [card: {card_line()}]", flush=True)
    out = {f"rank{r} {t}": {
        "step_ms_p50": round(s["step_ms_p50"], 3),
        "collective_ms_p50": round(s["collective_ms_p50"], 3),
        "steps": s["steps"], "peak_gb": round(s["peak_gb"], 2),
        "backend": s["backend"]} for (r, t), s in sorted(sums.items())}
    out["ttft_ms"] = {k: round(v, 1) for k, v in ttft.items()}
    out["env_part_s"] = round(t_env, 1)

    # -- parity: tp = 2 against tp = 1 on int8 quote weights -------------
    port = _free_port()
    procs = []
    try:
        for pid in range(2):
            plog = open(os.path.join(logdir, f"{leg}_parity{pid}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-rank"],
                env=_tp_env(SERVE_COORDINATOR=f"127.0.0.1:{port}",
                            JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                            MH_OUT=os.path.join(logdir,
                                                f"{leg}_parity{pid}.json")),
                stdout=plog, stderr=subprocess.STDOUT), plog))
        _mh_wait(procs, deadline + 60, f"{leg} parity")
    finally:
        _mh_kill(procs)
    ranks = [json.load(open(os.path.join(logdir, f"{leg}_parity{pid}.json")))
             for pid in range(2)]
    for r in ranks:
        check(len(set(r["digests"] or [None])) == 1 and r["digests"],
              f"{leg} parity: rank {r['rank']} digests {r['digests']}")
        for k in ("quant_matmul", "paged_attention_append",
                  "prefill_attention"):
            check(r["launches"][k] > 0, f"{leg} parity: rank {r['rank']} "
                  f"never launched {k}")
    cfg = get_config("llama3.1-8b")
    one = TorchEngine(quote_params(cfg, seed=0, quant="int8", device="cuda"),
                      cfg, ByteTokenizer(cfg.vocab_size), device="cuda",
                      **TP_ENGINE)
    tier = ranks[0]["tier"]
    try:
        one.warmup((256,), background=False)
        # The session parked at tp = 2, imported here and woken: the reply
        # of tp = 2's own wake, token for token. (First: the parity run
        # below retains its own copy of the long prompt's conversation,
        # which an import would not replace.)
        with open(os.path.join(logdir, f"{leg}_parity0.json.session"),
                  "rb") as f:
            check(one.session_import(f.read()) is not None,
                  f"{leg}: the tp = 2 session did not import at tp = 1")
        moved, _ = _tp_turn(one, TP_TIER_SUFFIX, ranks[0]["contexts"][1])
        check(one.metrics_snapshot()["kv_waked_total"] == 1,
              f"{leg}: the imported session did not wake at tp = 1")
        check(moved == tier["context2"], f"{leg}: the tp = 2 session woken "
              f"at tp = 1 parts from tp = 2's reply at context position "
              f"{_first_diff(moved, tier['context2'])}")
        want, _ = _tp_contexts(one)
        lines = []
        for (label, prompt, _), cold, got in zip(_tp_reqs(), want,
                                                 ranks[0]["contexts"]):
            n_prompt = len(one.scheduler.tokenizer.encode(prompt,
                                                          add_bos=True))
            lines.append(f"{label}: " + _against_cold(
                f"{leg} parity", one.scheduler, "tp = 2", got, cold,
                n_prompt))
    finally:
        one.stop()
        del one
        _free()
    print(f"server_multihost {leg} parity (int8 quote weights, greedy): "
          + "; ".join(lines) + "; peak a rank "
          + ", ".join(f"{r['peak_gb']:.1f}" for r in ranks)
          + f" GB; the leg in {time.monotonic() - t_leg:.0f} s [card: "
          f"{card_line()}]", flush=True)
    n_new = len(tier["context2"]) - len(ranks[0]["contexts"][1])
    print(f"server_multihost {leg} tier (int8 quote weights, int8 pool): "
          f"a {tier['tokens']}-token session parked in "
          f"{tier['park_ms']:.1f} ms (park_all of one key: the loop's "
          f"handshake, the gather on both ranks, the kv heads all-gathered "
          f"over gloo, the leader's readback), {tier['payload_bytes']} bytes "
          f"all-gathered = {tier['payload_bytes'] / tier['tokens']:.0f} "
          f"bytes per parked token ({tier['slots']} slots in its pages); "
          f"the follow-up ({n_new} ids more) woken: TTFT "
          f"{tier['wake_ttft_ms']:.1f} ms (kv_wake_p50_ms "
          f"{tier['kv_wake_p50_ms']}) against the cold first turn's "
          f"{tier['cold_ttft_ms']:.1f} ms (the same bucket and chunks); "
          "exported, imported at tp = 1 and woken there: the reply "
          f"equal to tp = 2's, token for token [card: {card_line()}]",
          flush=True)
    out["tier"] = {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in tier.items() if not k.startswith("context")}
    out["parity_peak_gb"] = [round(r["peak_gb"], 2) for r in ranks]
    out["leg_s"] = round(time.monotonic() - t_leg, 1)
    return out


def _mh_run(eng) -> list:
    """MH_REQS through the engine, enqueued at once; their texts."""
    from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                      GenerateRequest)
    gens = [eng.generate_stream(GenerateRequest(
        prompt=p, model="x", options=GenerateOptions.from_ollama(o)))
        for p, o in MH_REQS]
    return ["".join(g) for g in gens]


def phase_server_multihost(results: dict) -> None:
    """The lockstep multi-process plane (serve/multihost.py) on the card,
    three legs, each under MH_LEG_S with its processes killed in a
    ``finally``, then ``SERVE_TP`` in the continuous-batching engine
    (:func:`_tp2_engine_leg`, under TP_LEG_S):

    - dp2: two ``python -m p2p_llm_chat_tpu_torch.serve`` processes on the
      one card (``SERVE_COORDINATOR``, llama3.1-8b bf16 random init, 16 GB
      a rank, the byte tokenizer): MH_REQS concurrently over HTTP (each
      200 with tokens), ``/metrics`` requests above rounds, one
      ``/api/embed``, SIGTERM to the leader ends both with rc 0 within
      30 s, and each rank's summary shows kernels D and B (A8's decode
      mode) launched;
    - tp2: the same prompts through the plane in this process at tp = 1
      (a mesh of one, no world) on llama3.1-8b quote weights (bf16), then
      through two ranks at tp = 2 (``--mh-rank``, each drawing its shard
      of the same weights a layer at a time): greedy answers equal, the
      first round's
      logits within STEP_TOL, each round's gathered logits the same bytes
      on both ranks, kernels B and D launched on both;
    - nccl1: one process, a world of one, whose compute group is NCCL
      (llama3.2-1b): one request answers.

    The two ranks on one card share it over gloo (NCCL refuses two ranks
    on one device), which stages every collective through the host; the
    times printed are that, not the speed of tensor parallelism."""
    import tempfile
    import numpy as np
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.parallel.mesh import Mesh, MeshConfig
    from p2p_llm_chat_tpu_torch.serve.multihost import MultihostEngine
    from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
    logdir = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    serve = [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"]
    readings: dict = {}
    t_phase = time.monotonic()

    # -- dp2: the normal entry point ---------------------------------------
    leg = "dp2"
    sport = _free_port()
    url = f"http://127.0.0.1:{sport}"
    deadline = time.monotonic() + MH_LEG_S
    procs = _mh_spawn(2, logdir, leg, serve, MODEL_CONFIG="llama3.1-8b",
                      SERVE_ADDR=f"127.0.0.1:{sport}",
                      SERVE_MH_WINDOW_MS="250")
    try:
        _mh_up(url, procs, deadline, leg)
        t_up = time.monotonic()
        outs: list = [None] * len(MH_REQS)

        def go(i):
            prompt, opts = MH_REQS[i]
            outs[i] = _post(url + "/api/generate", {
                "model": "llama3.1-8b", "prompt": prompt, "stream": False,
                "options": opts}, timeout=MH_LEG_S)
        ts = [threading.Thread(target=go, args=(i,))
              for i in range(len(MH_REQS))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=max(1.0, deadline - time.monotonic()))
        burst_s = time.monotonic() - t_up
        for i, o in enumerate(outs):
            check(o is not None and o[0] == 200, f"{leg}: request {i} "
                  f"answered {o and o[0]}")
            body = json.loads(o[1])
            check(body["done"] and body["eval_count"] >= 1,
                  f"{leg}: request {i} generated nothing: {body}")
        m = _metrics(url)
        req_n = float(m["serve_multihost_requests"])
        rounds = float(m["serve_multihost_batched_rounds"])
        check(req_n > rounds, f"{leg}: {req_n} requests in {rounds} rounds")
        st, body = _post(url + "/api/embed", {"model": "llama3.1-8b",
                                              "input": ["see you at noon"]})
        check(st == 200 and len(json.loads(body)["embeddings"][0])
              == get_config("llama3.1-8b").hidden_size, f"{leg}: embed")
        procs[0][0].send_signal(15)
        _mh_wait(procs, time.monotonic() + 30, f"{leg} after SIGTERM")
    finally:
        _mh_kill(procs)
    sums = _mh_summaries(logdir, leg, 2)
    for s in sums:
        for k in ("prefill_attention", "dense_attention"):
            check(s["launches"][k] > 0, f"{leg}: rank {s['rank']} never "
                  f"launched {k}")
        check(s["backend"] == "gloo", f"{leg}: backend {s['backend']}")
        _record_launches(results, f"server_multihost dp2 rank {s['rank']}",
                         s["launches"])
    print(f"server_multihost {leg}: 2 ranks on one card, {req_n:.0f} "
          f"requests in {rounds:.0f} rounds in {burst_s:.2f} s, embed "
          f"answered, SIGTERM -> rc 0 both; launches rank 0 "
          f"{sums[0]['launches']}", flush=True)
    readings[leg] = _mh_line(f"server_multihost {leg}", sums)

    # -- tp2: parity against tp = 1 on the same weights --------------------
    leg = "tp2"
    cfg = get_config("llama3.1-8b")
    params = quote_params(cfg, seed=0, quant="", device="cuda")
    one = MultihostEngine(params, cfg, ByteTokenizer(cfg.vocab_size),
                          Mesh.at(MeshConfig(), 0), max_seq=512)
    first: list = []
    gather = one._gather_rows

    def hooked(x):
        a = gather(x)
        if not first:
            first.append(a)
        return a
    one._gather_rows = hooked
    try:
        want = _mh_run(one)
    finally:
        one.stop()
    tp1 = one.timings()
    del one, params, gather, hooked
    _free()
    deadline = time.monotonic() + MH_LEG_S
    port = _free_port()
    procs = []
    try:
        for pid in range(2):
            log = open(os.path.join(logdir, f"{leg}{pid}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mh-rank"],
                env=_mh_env(2, pid, port, MH_OUT=os.path.join(
                    logdir, f"{leg}{pid}.json")),
                stdout=log, stderr=subprocess.STDOUT), log))
        _mh_wait(procs, deadline, leg)
    finally:
        _mh_kill(procs)
    ranks = [json.load(open(os.path.join(logdir, f"{leg}{pid}.json")))
             for pid in range(2)]
    got = np.load(os.path.join(logdir, f"{leg}0.json.logits.npy"))
    greedy = [i for i, (_, o) in enumerate(MH_REQS)
              if not o.get("temperature")]
    for i in greedy:
        check(ranks[0]["texts"][i] == want[i], f"{leg}: greedy request {i} "
              f"answered {ranks[0]['texts'][i]!r} at tp = 2, {want[i]!r} at "
              "tp = 1")
    scale = float(np.abs(first[0]).max())
    err = float(np.abs(got - first[0]).max())
    check(err <= STEP_TOL * scale, f"{leg}: first round's logits off by "
          f"{err} (max|logits| {scale})")
    check(ranks[0]["crcs"] == ranks[1]["crcs"] and ranks[0]["crcs"],
          f"{leg}: the ranks' gathered logits differ")
    for r in ranks:
        for k in ("prefill_attention", "dense_attention"):
            check(r["launches"][k] > 0, f"{leg}: rank {r['rank']} never "
                  f"launched {k}")
        _record_launches(results, f"server_multihost tp2 rank {r['rank']}",
                         r["launches"])
    print(f"server_multihost {leg}: greedy answers {len(greedy)} of "
          f"{len(MH_REQS)} equal at tp = 1 and tp = 2 (e.g. "
          f"{want[greedy[0]][:40]!r}); first round's logits max|diff| "
          f"{err:.4g} of max {scale:.4g}; {len(ranks[0]['crcs'])} rounds' "
          "and steps' gathered logits the same bytes on both ranks; tp = 1 "
          f"in this process: round {tp1['round_ms_p50']:.1f} ms, step "
          f"{tp1['step_ms_p50']:.2f} ms", flush=True)
    readings[leg] = _mh_line(f"server_multihost {leg}", ranks)
    readings[leg]["tp1"] = {k: round(tp1[k], 3)
                            for k in ("round_ms_p50", "step_ms_p50")}
    print(f"server_multihost {leg}: peak a rank "
          f"{max(r['peak_mb'] for r in ranks) / 1024:.1f} GB with the shard "
          "drawn a layer at a time (building the whole bf16 tree first, "
          "then cutting it, peaked at 26.7 GB: PERF.md §6) "
          f"[card: {card_line()}]", flush=True)

    readings["tp2_engine"] = _tp2_engine_leg(results, logdir)

    # -- nccl1: a world of one on NCCL -------------------------------------
    leg = "nccl1"
    sport = _free_port()
    url = f"http://127.0.0.1:{sport}"
    deadline = time.monotonic() + MH_LEG_S
    procs = _mh_spawn(1, logdir, leg, serve, MODEL_CONFIG="llama3.2-1b",
                      SERVE_ADDR=f"127.0.0.1:{sport}")
    try:
        _mh_up(url, procs, deadline, leg)
        st, body = _post(url + "/api/generate", {
            "model": "llama3.2-1b", "prompt": "hi", "stream": False,
            "options": {"num_predict": 8}}, timeout=MH_LEG_S)
        check(st == 200 and json.loads(body)["eval_count"] >= 1,
              f"{leg}: {st} {body[:200]}")
        procs[0][0].send_signal(15)
        _mh_wait(procs, time.monotonic() + 30, f"{leg} after SIGTERM")
    finally:
        _mh_kill(procs)
    s = _mh_summaries(logdir, leg, 1)[0]
    check(s["backend"] == "nccl", f"{leg}: compute backend {s['backend']}")
    _record_launches(results, "server_multihost nccl1", s["launches"])
    print(f"server_multihost {leg}: a world of one, compute group on "
          f"{s['backend']}, one request answered, SIGTERM -> rc 0", flush=True)
    results["_server_multihost"] = readings
    print(f"server_multihost: four legs in {time.monotonic() - t_phase:.0f}"
          f" s [card: {card_line()}]", flush=True)


# -- step_parallel: the pipeline and ring programs (parallel/pipeline.py,
# parallel/ring.py) on one world of four rank processes on the one card -----

PAR_LEG_S = 90       # each leg's limit, and set-up's, in every rank
PAR_RANKS = 4
PAR_MODELS = {"llama": ("llama3.1-8b", 4), "mixtral": ("mixtral-8x7b", 2)}
# leg -> (mesh axes, model, traffic); traffic -> (batch, bucket, prompt
# lengths, decode steps, (step, row) parked by ``active`` or None)
PAR_TRAFFIC = {
    "pp": (4, 1024, (1000, 1016, 700, 512), 8, None),
    "ring": (2, 4096, (4000, 3000), 8, (3, 1)),
    "moe": (1, 2048, (2000,), 4, None),
}
PAR_LEGS = {
    "pp2": (dict(pp=2), "llama", "pp"),
    "sp2": (dict(sp=2), "llama", "ring"),
    "sp2xtp2": (dict(sp=2, tp=2), "llama", "ring"),
    "sp2xep2": (dict(ep=2, sp=2), "mixtral", "moe"),
}
PAR_MICROBATCHES = 2


def _par_config(model: str):
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    name, layers = PAR_MODELS[model]
    return get_config(name).with_(num_layers=layers)


def _par_traffic(name: str):
    """(tokens [B, S] right-padded with 0, prompt lengths [B], active
    [steps, B]) of a traffic, from a seed of its own."""
    import numpy as np
    B, S, lens, steps, parked = PAR_TRAFFIC[name]
    rng = np.random.default_rng(10 * S + B)
    toks = np.zeros((B, S), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(32, 127, n)
    active = np.ones((steps, B), bool)
    if parked is not None:
        active[parked] = False
    return toks, np.array(lens, np.int32), active


def _par_positions(name: str) -> list:
    """The (row, position) pairs whose logits are compared: every 256th
    prompt position and each row's last."""
    _, _, lens, _, _ = PAR_TRAFFIC[name]
    return [(b, p) for b, n in enumerate(lens)
            for p in sorted(set(range(0, n, 256)) | {n - 1})]


def _par_kv_positions(name: str, final_lengths) -> list:
    """The (row, slot) pairs of the k cache compared: the logits'
    positions and every slot decode committed."""
    _, _, lens, _, _ = PAR_TRAFFIC[name]
    return sorted(set(_par_positions(name))
                  | {(b, p) for b, n in enumerate(lens)
                     for p in range(n, int(final_lengths[b]))})


def _par_oracle(model: str, traffic: str, params, cfg, dev) -> dict:
    """The single-rank forms on the card (prefill into a dense cache, then
    greedy decode steps): the port's own result the parallel forms are
    held against. MoE prefill dropless (``capacity=None``), as the
    ring's."""
    import numpy as np
    import torch
    from p2p_llm_chat_tpu_torch.models import family_for
    from p2p_llm_chat_tpu_torch.models.llama import KVCache
    fam = family_for(cfg)
    toks, lens, active = _par_traffic(traffic)
    B, S = toks.shape
    kw = {"capacity": None} if cfg.is_moe else {}
    cache = KVCache.create(cfg, B, S, device=dev)
    t = torch.from_numpy(toks).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    with torch.no_grad():
        lg, cache = fam.prefill(params, cfg, t, ln, cache=cache, **kw)
        rows = torch.arange(B, device=dev)
        nxt = lg[rows, ln.long() - 1].argmax(-1)
        out = {"first": nxt.cpu().numpy()}
        pos = _par_positions(traffic)
        out["logits"] = torch.stack([lg[b, p] for b, p in pos]).cpu().numpy()
        del lg
        chain, steps = [nxt.cpu().numpy()], []
        for i in range(active.shape[0]):
            lg, cache = fam.decode_step(
                params, cfg, nxt[:, None], cache,
                torch.from_numpy(active[i]).to(dev))
            nxt = lg[:, 0].argmax(-1)
            steps.append(lg[:, 0].cpu().numpy())
            chain.append(nxt.cpu().numpy())
        out["steps"] = np.stack(steps)
        out["tokens"] = np.stack(chain)
        out["lengths"] = cache.lengths.cpu().numpy()
        kv = _par_kv_positions(traffic, out["lengths"])
        out["k"] = torch.stack([cache.k[:, b, p] for b, p in kv]
                               ).float().cpu().numpy()    # [n, L, Hkv, D]
    return out


def _par_launches() -> dict:
    from p2p_llm_chat_tpu_torch.ops.dense_attention import dense_attention
    from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
        prefill_attention)
    out = _launch_counts()
    out["prefill_attention_lse"] = prefill_attention.lse_launches
    out["dense_attention_lse"] = dense_attention.lse_launches
    return out


def _par_zero() -> None:
    from p2p_llm_chat_tpu_torch.ops.dense_attention import dense_attention
    from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
        prefill_attention)
    for w in _wrappers().values():
        w.launches = 0
    prefill_attention.lse_launches = dense_attention.lse_launches = 0


def _par_leg(leg: str, mesh, params, cfg, dev) -> dict:
    """One leg on this rank: the parallel prefill and greedy decode steps
    of its traffic, timed (host wall around each call with the card
    synchronised; the time in collectives from the mesh's CUDA events),
    with the bytes this rank sent, its peak memory and its launches."""
    import zlib
    import numpy as np
    import torch
    from p2p_llm_chat_tpu_torch.parallel.pipeline import (pp_decode_step,
                                                          pp_prefill)
    from p2p_llm_chat_tpu_torch.parallel.ring import (moe_ring_mlp_fn,
                                                      ring_prefill,
                                                      sp_decode_step)
    axes, model, traffic = PAR_LEGS[leg]
    toks, lens, active = _par_traffic(traffic)
    B, S = toks.shape
    t = torch.from_numpy(toks).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    pp = "pp" in axes
    fn = moe_ring_mlp_fn(cfg, "ep", mesh) if cfg.is_moe else None
    sp = axes.get("sp", 1)
    my = mesh.coords.get("sp", 0)
    _par_zero()
    torch.cuda.reset_peak_memory_stats(dev)
    out, res = {}, {"rank": mesh.rank, "backend": mesh.backend}

    def timed(call):
        torch.cuda.synchronize(dev)
        mesh.drop_collective_timing()
        t0 = time.perf_counter()
        r = call()
        torch.cuda.synchronize(dev)
        return r, (time.perf_counter() - t0) * 1e3, mesh.take_collective_ms()

    sent0 = mesh.sent_bytes
    with torch.no_grad():
        if pp:
            (lg, cache), ms, coll = timed(lambda: pp_prefill(
                params, cfg, t, ln, mesh, microbatches=PAR_MICROBATCHES,
                last_only=True))
            nxt = lg[:, 0].argmax(-1)
            out["logits"] = lg[:, 0].cpu().numpy()
            sends = PAR_MICROBATCHES if mesh.coords["pp"] < axes["pp"] - 1 \
                else 0
        else:
            (lg, cache), ms, coll = timed(lambda: ring_prefill(
                params, cfg, t, ln, mesh, mlp_fn=fn))
            Sl = S // sp
            pos = [(b, p) for b, p in _par_positions(traffic)
                   if my * Sl <= p < (my + 1) * Sl]
            out["logits"] = torch.stack([lg[b, p - my * Sl] for b, p in pos]
                                        ).cpu().numpy()
            out["logit_pos"] = np.array(pos)
            # Each row's first token from the rank that holds its last
            # prompt position (the harness's, outside the timed call).
            first = torch.zeros(B, dtype=torch.float32, device=dev)
            for b, n in enumerate(lens):
                if my * Sl <= n - 1 < (my + 1) * Sl:
                    first[b] = lg[b, n - 1 - my * Sl].argmax().float()
            nxt = mesh.all_reduce(first, "sp").long()
            mesh.drop_collective_timing()
            sends = cfg.num_layers * (sp - 1)
        del lg
        res.update(prefill_ms=ms, prefill_coll_ms=coll,
                   sent_bytes=mesh.sent_bytes - sent0, sends=sends)
        chain, steps, walls, colls = [nxt.cpu().numpy()], [], [], []
        for i in range(active.shape[0]):
            act = torch.from_numpy(active[i]).to(dev)
            if pp:
                (lg, cache), ms, coll = timed(lambda: pp_decode_step(
                    params, cfg, nxt[:, None], cache, mesh, active=act))
            else:
                (lg, cache), ms, coll = timed(lambda: sp_decode_step(
                    params, cfg, nxt[:, None], cache, mesh, active=act,
                    mlp_fn=fn))
            walls.append(ms)
            colls.append(coll)
            nxt = lg[:, 0].argmax(-1)
            steps.append(lg[:, 0].cpu().numpy())
            chain.append(nxt.cpu().numpy())
        res["launches"] = _par_launches()
        res.update(decode_ms=walls, decode_coll_ms=colls,
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
        steps = np.stack(steps)
        res["steps_crc"] = zlib.crc32(steps.tobytes())
        res["logits_crc"] = zlib.crc32(out["logits"].tobytes())
        out["steps"] = steps
        out["tokens"] = np.stack(chain)
        out["lengths"] = cache.lengths.cpu().numpy()
        # This rank's part of the k cache at the compared slots: its
        # layers (a stage), its sequence shard and its kv heads.
        Sl = cache.max_seq if not pp else S
        lo_layer = mesh.coords["pp"] * cfg.num_layers // axes["pp"] \
            if pp else 0
        kv = [(b, p) for b, p in _par_kv_positions(traffic, out["lengths"])
              if pp or my * Sl <= p < (my + 1) * Sl]
        out["k"] = torch.stack([cache.k[:, b, p - (0 if pp else my * Sl)]
                                for b, p in kv]).float().cpu().numpy()
        out["k_pos"] = np.array(kv)
        Hl = cache.k.shape[3]
        res.update(layer_lo=lo_layer, head_lo=mesh.coords.get("tp", 0) * Hl)
    return out, res


def _par_rank_main() -> int:
    """One rank of step_parallel (``chip_smoke.py --par-rank``): joins the
    world of four, builds every leg's mesh in one order (``new_group`` is
    collective), draws each model's whole quote tree on the card from
    seed 0 and keeps its cut of it per leg; rank 0 also runs the
    single-rank oracle of each traffic. Each leg (and set-up) has
    PAR_LEG_S seconds (SIGALRM, which ends the process); results go to
    PAR_OUT as ``<leg>.rank<r>.npz`` / ``.json``, the oracle's as
    ``<traffic>.oracle.npz``."""
    import signal
    import numpy as np
    import torch
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    from p2p_llm_chat_tpu_torch.parallel import distributed, sharding
    from p2p_llm_chat_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from p2p_llm_chat_tpu_torch.parallel.ring import shard_ring_params
    signal.alarm(PAR_LEG_S)
    distributed.init_distributed(join_timeout_s=60)
    dev = distributed.rank_device()
    torch.cuda.set_device(dev)
    rank = torch.distributed.get_rank()
    out_dir = os.environ["PAR_OUT"]
    backend = distributed.compute_backend(dev)
    meshes = {}
    for leg, (axes, _, _) in PAR_LEGS.items():
        mc = MeshConfig(**axes)
        meshes[leg] = make_mesh(mc, list(range(mc.size)), backend=backend)
    for model in ("llama", "mixtral"):
        signal.alarm(PAR_LEG_S)
        cfg = _par_config(model)
        params = quote_params(cfg, seed=0, quant="int8", device=dev)
        if rank == 0:
            for traffic in sorted({tr for _, m, tr in PAR_LEGS.values()
                                   if m == model}):
                np.savez(os.path.join(out_dir, f"{traffic}.oracle.npz"),
                         **_par_oracle(model, traffic, params, cfg, dev))
        torch.distributed.barrier()
        for leg, (axes, m, _) in PAR_LEGS.items():
            if m != model:
                continue
            signal.alarm(PAR_LEG_S)
            mesh = meshes[leg]
            if mesh.coords:
                part = (sharding.stage_layers(params, cfg, mesh, dev)
                        if "pp" in axes
                        else shard_ring_params(params, cfg, mesh, dev))
                arrays, res = _par_leg(leg, mesh, part, cfg, dev)
                del part
                base = os.path.join(out_dir, f"{leg}.rank{rank}")
                np.savez(base + ".npz", **arrays)
                with open(base + ".json", "w") as f:
                    json.dump(res, f)
                torch.cuda.empty_cache()
            torch.distributed.barrier()
        del params
        torch.cuda.empty_cache()
    signal.alarm(0)
    distributed.leave_world()
    return 0


def _par_check_leg(results: dict, leg: str, out_dir: str) -> dict:
    """Hold one leg's ranks against the oracle of its traffic; print and
    return its readings."""
    import numpy as np
    axes, model, traffic = PAR_LEGS[leg]
    n = int(np.prod(list(axes.values())))
    ref = dict(np.load(os.path.join(out_dir, f"{traffic}.oracle.npz")))
    ranks, sums = [], []
    for r in range(n):
        base = os.path.join(out_dir, f"{leg}.rank{r}")
        ranks.append(dict(np.load(base + ".npz")))
        with open(base + ".json") as f:
            sums.append(json.load(f))
    pp = "pp" in axes
    # Logits: pp's last prompt positions (every rank, the last stage's
    # broadcast); the ring's compared positions, each rank its chunk's.
    err = scale = 0.0
    if pp:
        want = ref["logits"][[i for i, (b, p) in enumerate(
            _par_positions(traffic)) if p == PAR_TRAFFIC[traffic][2][b] - 1]]
        for r in range(n):
            err = max(err, float(np.abs(ranks[r]["logits"] - want).max()))
        scale = float(np.abs(want).max())
    else:
        index = {tuple(x): i for i, x in enumerate(_par_positions(traffic))}
        seen = set()
        for r in range(n):
            rows = [index[tuple(x)] for x in ranks[r]["logit_pos"]]
            seen.update(rows)
            want = ref["logits"][rows]
            err = max(err, float(np.abs(ranks[r]["logits"] - want).max()))
            scale = max(scale, float(np.abs(want).max()))
        check(seen == set(index.values()), f"step_parallel {leg}: the ranks "
              "returned logits for only some of the compared positions")
        if "tp" in axes:           # a chunk's two tp ranks, bitwise
            for r in range(0, n, 2):
                a_, b_ = ranks[r]["logits"], ranks[r + 1]["logits"]
                check(sums[r]["logits_crc"] == sums[r + 1]["logits_crc"],
                      f"step_parallel {leg}: ranks {r} and {r + 1} return "
                      f"their chunk's logits differently (max|diff| "
                      f"{np.abs(a_ - b_).max():.3e}, {(a_ != b_).mean():.2%}"
                      f" of them, rows {sorted(set(np.nonzero(a_ != b_)[0].tolist()))[:20]})")
    check(err <= PAR_TOL * scale, f"step_parallel {leg}: prefill logits err "
          f"{err:.3e} > {PAR_TOL} of max|oracle| {scale:.3e}")
    steps_err = float(np.abs(ranks[0]["steps"] - ref["steps"]).max())
    steps_scale = float(np.abs(ref["steps"]).max())
    check(steps_err <= PAR_TOL * steps_scale, f"step_parallel {leg}: decode "
          f"logits err {steps_err:.3e} > {PAR_TOL} of {steps_scale:.3e}")
    for r in range(n):
        check(np.array_equal(ranks[r]["tokens"], ref["tokens"]),
              f"step_parallel {leg}: rank {r}'s greedy tokens "
              f"{ranks[r]['tokens'].T.tolist()} differ from the oracle's "
              f"{ref['tokens'].T.tolist()}")
        check(sums[r]["steps_crc"] == sums[0]["steps_crc"],
              f"step_parallel {leg}: rank {r}'s decode logits differ from "
              "rank 0's")
        check(np.array_equal(ranks[r]["lengths"], ref["lengths"]),
              f"step_parallel {leg}: rank {r}'s lengths "
              f"{ranks[r]['lengths']} != {ref['lengths']}")
    # The k cache at the compared slots: each rank's layers, sequence
    # shard and kv heads against the oracle's.
    kv_index = {tuple(x): i for i, x in enumerate(
        _par_kv_positions(traffic, ref["lengths"]))}
    k_err = k_scale = 0.0
    for r in range(n):
        got = ranks[r]["k"]                     # [n, L_r, H_r, D]
        rows = [kv_index[tuple(x)] for x in ranks[r]["k_pos"]]
        lo, h0 = sums[r]["layer_lo"], sums[r]["head_lo"]
        want = ref["k"][rows][:, lo:lo + got.shape[1], h0:h0 + got.shape[2]]
        k_err = max(k_err, float(np.abs(got - want).max()))
        k_scale = max(k_scale, float(np.abs(want).max()))
    check(k_err <= PAR_TOL * k_scale, f"step_parallel {leg}: k cache err "
          f"{k_err:.3e} > {PAR_TOL} of {k_scale:.3e}")
    # Kernels D and B on every rank (with the log-sum-exp on the ring's),
    # A on every rank (the decode projections; the experts' grid on MoE).
    ring = not pp
    for s in sums:
        L = s["launches"]
        need = ["prefill_attention", "dense_attention", "quant_matmul"]
        if model == "mixtral":
            need.append("quant_matmul_experts_stacked")
        for k in need:
            check(L.get(k, 0) > 0, f"step_parallel {leg}: rank {s['rank']} "
                  f"never launched {k}")
        check(L["prefill_attention_lse"] == (L["prefill_attention"] if ring
                                             else 0)
              and L["dense_attention_lse"] == (L["dense_attention"] if ring
                                               else 0),
              f"step_parallel {leg}: rank {s['rank']}'s log-sum-exp "
              f"launches {L}")
        _record_launches(results, f"step_parallel {leg} rank {s['rank']}",
                         {k: v for k, v in L.items()
                          if not k.endswith("_lse")})
    per = []
    for s in sums:
        dec, dcoll = _p50(s["decode_ms"]), _p50(s["decode_coll_ms"])
        per.append(dict(
            rank=s["rank"], prefill_ms=round(s["prefill_ms"], 3),
            prefill_coll_share=round(s["prefill_coll_ms"]
                                     / s["prefill_ms"], 4),
            decode_step_ms_p50=round(dec, 3),
            decode_coll_ms_p50=round(dcoll, 3),
            bytes_per_send=(s["sent_bytes"] // s["sends"] if s["sends"]
                            else 0),
            peak_gb=round(s["peak_gb"], 3), backend=s["backend"],
            launches={k: v for k, v in s["launches"].items() if v}))
    what = "handoff" if pp else "ring hop"
    print(f"  step_parallel {leg} ({model}, {n} ranks, "
          f"{PAR_MODELS[model][1]} layers; B={PAR_TRAFFIC[traffic][0]}, "
          f"S={PAR_TRAFFIC[traffic][1]}): prefill logits max_abs_err "
          f"{err:.3e} (tol {PAR_TOL} of max|oracle| {scale:.3e}), decode "
          f"logits {steps_err:.3e} (of {steps_scale:.3e}), k cache "
          f"{k_err:.3e} (of {k_scale:.3e}); greedy tokens equal over "
          f"{len(ref['steps'])} steps; decode logits bitwise equal on every "
          f"rank", flush=True)
    for p in per:
        print(f"    rank {p['rank']}: prefill {p['prefill_ms']:.1f} ms "
              f"({p['prefill_coll_share']:.1%} in collectives), decode step "
              f"p50 {p['decode_step_ms_p50']:.2f} ms ({p['decode_coll_ms_p50']:.2f}"
              f" ms, {p['decode_coll_ms_p50'] / p['decode_step_ms_p50']:.1%}"
              f" in collectives), {p['bytes_per_send']:,} bytes a "
              f"{what} sent, peak {p['peak_gb']:.2f} GB, backend "
              f"{p['backend']}; launches {p['launches']}", flush=True)
    return {"logits_max_abs_err": err, "decode_max_abs_err": steps_err,
            "k_max_abs_err": k_err, "ranks": per}


def phase_step_parallel(results: dict) -> None:
    """The pipeline and ring programs on the card: one world of four rank
    processes (``chip_smoke.py --par-rank``) over gloo on the one card,
    four legs — pp = 2 (llama3.1-8b cut to 4 layers, B = 4, S = 1024, 2
    microbatches, 8 greedy steps), sp = 2 (B = 2, S = 4096, prompts of
    4000 and 3000, 8 steps, row 1 parked in one), sp 2 x tp 2 (the same
    traffic) and sp 2 x ep 2 (mixtral-8x7b cut to 2 layers, B = 1, S =
    2048, 4 steps) — all on int8 quote weights, each held against the
    single-rank prefill and decode of the same weights on the card
    (rank 0): logits and the k cache within PAR_TOL, greedy tokens
    equal, decode logits bitwise equal on every rank, kernels D and B on
    every rank (with their log-sum-exp on the ring's legs) and kernel A.
    Two ranks time-slice one card and gloo stages every transfer through
    the host: no figure here is the speed of pp or sp across cards."""
    import tempfile
    from p2p_llm_chat_tpu_torch.ops import _build
    for name in _build.KERNELS:          # built once, before the ranks
        _build.build(name)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_par_")
    t0 = time.monotonic()
    procs = _mh_spawn(PAR_RANKS, out_dir, "par",
                      [sys.executable, os.path.abspath(__file__),
                       "--par-rank"], PAR_OUT=out_dir)
    try:
        _mh_wait(procs, t0 + PAR_LEG_S * (len(PAR_LEGS) + 2),
                 "step_parallel")
    finally:
        _mh_kill(procs)
    world_s = time.monotonic() - t0
    readings = {leg: _par_check_leg(results, leg, out_dir)
                for leg in PAR_LEGS}
    readings["world_s"] = round(world_s, 1)
    results["_step_parallel"] = readings
    print(f"step_parallel: four legs in {world_s:.0f} s (world of "
          f"{PAR_RANKS} ranks, gloo on one card) [card: {card_line()}]",
          flush=True)


# Phase names for --only; a family name runs all of its members.
PHASES = {
    "build": ("build",),
    "kernel": ("kernel_a", "kernel_b", "kernel_b_pool", "kernel_b_verify",
               "kernel_c", "kernel_experts", "kernel_d", "kernel_e",
               "kernel_dense"),
    "step": ("step_llama", "step_llama_wta", "step_mixtral", "step_dense",
             "step_parallel"),
    "server": ("server_llama", "server_llama_wta", "server_mixtral",
               "server_spec", "server_tier", "server_ckpt", "server_multi",
               "server_dense", "server_draft", "server_multihost"),
    "profile": ("profile_llama", "profile_llama_wta", "profile_mixtral",
                "profile_prefill", "profile_tools"),
}


def _free() -> None:
    """Return what the last phase held to the card before the next one
    builds (engines hold reference cycles through their threads)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    if sys.argv[1:] == ["--mh-rank"]:       # one rank of server_multihost
        return _mh_rank_main()
    if sys.argv[1:] == ["--tp-rank"]:       # one rank of its tp2_engine leg
        return _tp_rank_main()
    if sys.argv[1:] == ["--par-rank"]:      # one rank of step_parallel
        return _par_rank_main()
    ap.add_argument("--only", default="build,kernel,step,server",
                    help="comma-separated phases to run: "
                    + ", ".join(f"{k} ({'/'.join(v)})"
                                for k, v in PHASES.items()))
    phases = set()
    for name in ap.parse_args().only.split(","):
        phases.update(PHASES.get(name, (name,)))
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

    def done(what: str) -> None:
        _free()
        print(f"{what} done ({time.monotonic() - t0:.0f} s)", flush=True)

    runs = [
        ("build", phase_build),
        ("kernel_a", lambda: phase_kernel_a(results)),
        ("kernel_b", lambda: phase_kernel_b(results)),
        ("kernel_b_pool", lambda: phase_kernel_b_pool(results)),
        ("kernel_b_verify", lambda: phase_kernel_b_verify(results)),
        ("kernel_c", lambda: phase_kernel_c(results)),
        ("kernel_experts", lambda: phase_kernel_experts(results)),
        ("kernel_d", lambda: phase_kernel_d(results)),
        ("kernel_e", lambda: phase_kernel_e(results)),
        ("kernel_dense", lambda: phase_kernel_dense(results)),
        ("step_llama", lambda: phase_step("llama3.1-8b", "int8", True)),
        ("step_llama_wta", lambda: phase_step("llama3.1-8b", "int8", False,
                                              impl="kernel")),
        ("step_mixtral", lambda: phase_step("mixtral-8x7b", "int8", True)),
        ("step_mixtral", lambda: phase_step("mixtral-8x7b", "int4", False)),
        ("step_dense", lambda: phase_step_dense("llama3.1-8b", "int8")),
        ("step_dense", lambda: phase_step_dense("mixtral-8x7b", "int4")),
        ("step_parallel", lambda: phase_step_parallel(results)),
        ("server_llama", lambda: phase_server(
            results, "llama3.1-8b", "int8",
            ("quant_matmul", "paged_attention_append", "prefill_attention"),
            capture=True, copilot=True)),
        ("server_llama", lambda: phase_server(
            results, "llama3.1-8b", "int8",
            ("quant_matmul", "paged_attention_append", "prefill_attention"),
            prefill_chunk=0)),
        ("server_llama_wta", lambda: phase_server(
            results, "llama3.1-8b", "int8",
            ("quant_matmul", "paged_attention", "prefill_attention"),
            impl="kernel")),
        ("server_mixtral", lambda: phase_server(
            results, "mixtral-8x7b", "int8",
            ("quant_matmul", "quant_matmul_experts_stacked",
             "paged_attention_append", "prefill_attention"))),
        ("server_mixtral", lambda: phase_server(
            results, "mixtral-8x7b", "int4",
            ("quant_matmul4", "quant_matmul_experts_stacked4",
             "dense_attention", "prefill_attention"), kv="dense")),
        ("server_spec", lambda: phase_server_spec(
            results, "llama3.1-8b", "int8")),
        ("server_spec", lambda: phase_server_spec(
            results, "llama3.1-8b", "int8", nodes=0)),
        ("server_spec", lambda: phase_server_spec(
            results, "llama3.1-8b", "int8", impl="kernel", nodes=0)),
        ("server_spec", lambda: phase_server_spec(
            results, "mixtral-8x7b", "int4")),
        ("server_tier", lambda: phase_server_tier(results)),
        ("server_ckpt", lambda: phase_server_ckpt(results)),
        ("server_multi", lambda: phase_server_multi(results)),
        ("server_dense", lambda: phase_server_dense(results)),
        ("server_draft", lambda: phase_server_draft(results)),
        ("server_multihost", lambda: phase_server_multihost(results)),
        ("profile_llama", lambda: phase_profile(results, "llama3.1-8b",
                                                "int8")),
        ("profile_llama_wta", lambda: phase_profile(
            results, "llama3.1-8b", "int8", impl="kernel")),
        ("profile_mixtral", lambda: phase_profile(results, "mixtral-8x7b",
                                                  "int8")),
        ("profile_mixtral", lambda: phase_profile(results, "mixtral-8x7b",
                                                  "int4")),
        ("profile_prefill", lambda: phase_profile_prefill("llama3.1-8b",
                                                          "int8")),
        ("profile_tools", lambda: phase_profile_tools(results)),
    ]
    try:
        for name, run in runs:
            if name in phases:
                print(f"{name}:", flush=True)
                run()
                done(name)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        _drop_ckpts()
    print(f"chip_smoke: every phase passed in {time.monotonic() - t0:.0f} s",
          flush=True)
    print(f"card: {card_line()}", flush=True)
    readings = {k: results.pop(k) for k in list(results)
                if k.startswith("_")}
    if readings:
        print(json.dumps({"readings": readings}), flush=True)
    if results:
        print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
