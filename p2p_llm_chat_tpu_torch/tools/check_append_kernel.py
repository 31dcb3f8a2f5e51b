"""Kernel B's append mode against its plain version: the twin of the
reference's tools/check_append_kernel.py.

The reference checks its two Pallas append kernels (the gathered-window
block kernel and the multi-chunk flash kernel) against the XLA gather
path at the reference's cases (:data:`CASES`): bench-1b, 32 rows, pages
of 64 tokens, int8 and bf16 pools, a 3-page serving window (block) and a
48-page window (flash: 3 chunks of 1024 int8 tokens, 6 of 512 bf16).
The port has one append kernel for every window
(ops/paged_attention.paged_attention_append; its split plan covers the
long window the flash kernel was for), so each case runs that kernel, at
the first and the last layer, against ``paged_attention_append_reference``
on the same random pool: every row a random length in [1, window - 1),
its own pages, and the current token's k/v. The relative error must stay
under 2e-2 of the largest output, the reference's tolerance.

    python -m p2p_llm_chat_tpu_torch.tools.check_append_kernel [--config bench-1b] [--batch 32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..models.configs import get_config
from ..ops.paged_attention import (paged_attention_append,
                                   paged_attention_append_reference)
from ..ops.paged_kv import PagedKVCache
from .card import Rows, add_device_arg, resolve

TOL = 2e-2
# (label, quantized, pages a row, page size, seed): the reference's
# run(True), run(False), run_flash(True), run_flash(False).
CASES = (("block", True, 3, 64, 0), ("block", False, 3, 64, 0),
         ("flash", True, 48, 64, 1), ("flash", False, 48, 64, 1))


def random_pool(config, B: int, pages: int, ps: int, quantized: bool,
                seed: int, dev: torch.device):
    """A pool of ``B`` rows with their own ``pages`` pages each, random
    contents (int8 values with positive scales, or bf16 normals) and a
    random length a row in [1, pages * ps - 1); (cache, lengths)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache = PagedKVCache.create(config, B, B * pages + 1, ps,
                                max_pages_per_row=pages, quantized=quantized,
                                device=dev)
    if quantized:
        for t in (cache.k, cache.v):
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  device=dev, dtype=torch.int8))
        for t in (cache.k_scale, cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02
                    + 0.002)
    else:
        for t in (cache.k, cache.v):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    cache.page_table.copy_((1 + torch.arange(B * pages, device=dev,
                                             dtype=torch.int32))
                           .reshape(B, pages))
    lengths = rng.integers(1, pages * ps - 1, size=B)
    cache.lengths.copy_(torch.as_tensor(lengths, dtype=torch.int32))
    return cache


def run(label: str, quantized: bool, pages: int, ps: int, seed: int, *,
        config: str, B: int, dev: torch.device, show=print) -> float:
    """One case at the first and the last layer; the largest relative
    error (AssertionError past TOL)."""
    cfg = get_config(config)
    cache = random_pool(cfg, B, pages, ps, quantized, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q = rnd(B, cfg.num_heads, cfg.head_dim)
    k_cur = rnd(B, cfg.num_kv_heads, cfg.head_dim)
    v_cur = rnd(B, cfg.num_kv_heads, cfg.head_dim)
    worst = 0.0
    for layer in (0, cfg.num_layers - 1):
        got = paged_attention_append(q, k_cur, v_cur, cache, cache.lengths,
                                     layer, pages=pages).float()
        ref = paged_attention_append_reference(
            q, k_cur, v_cur, cache, cache.lengths, layer,
            pages=pages).float()
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        worst = max(worst, rel)
        show(f"{label} (kernel B append mode, {pages} pages of {ps}) "
             f"quantized={quantized} layer={layer}: max abs err {err:.5f} "
             f"(rel {rel:.5f})")
        assert rel < TOL, f"{label}: kernel B diverges from the plain version"
    return worst


def main(argv: Optional[list[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="bench-1b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cases", default="all",
                    help="'all' or indices into CASES, e.g. 0,2")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    show = Rows(dev)
    picks = (range(len(CASES)) if args.cases == "all"
             else [int(i) for i in args.cases.split(",")])
    launches = paged_attention_append.launches
    errs = [run(*CASES[i], config=args.config, B=args.batch, dev=dev,
                show=show) for i in picks]
    show(f"append kernel parity OK ({len(errs)} cases, {args.config}, "
         f"B={args.batch}; kernel B launched "
         f"{paged_attention_append.launches - launches} times)")
    return errs


if __name__ == "__main__":
    main()
