"""Kernel B's append mode timed per 22-layer walk: the twin of the
reference's tools/time_append_kernel.py.

The reference loops its append kernel inside one jitted scan over the
layer indices of bench-1b (22 layers; 32 rows, 3 pages of 64, 150 tokens
a row, the int8 pool unless ``TK_QUANT=0``), each call's output the next
call's q, at two scan lengths (5 and 20 walks) whose difference cancels
the dispatch round trip. Here the same chained calls are captured into
two CUDA graphs of those lengths and differenced the same way
(card.step_ms on the card: mm_micro's ``device_ms`` / ``two_length_ms``).

The reference also timed a "DMA-only" cut-down of its kernel. The port's
kernel carries no measurement-only variant (a cut-down is timed from a
scratch copy of the source, never from an option left in the shipped
kernel), so that column has no counterpart; the bytes bound of a walk is
printed in its place: the live tokens' k and v (and an int8 pool's
scales), the current token's k and v, q and the output, each moved once
at the memory rate.

    python -m p2p_llm_chat_tpu_torch.tools.time_append_kernel [--config bench-1b] [--batch 32] [--walks 5,20] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from ..models.configs import get_config
from ..ops.paged_attention import paged_attention_append
from ..ops.paged_kv import PagedKVCache
from .card import Rows, add_device_arg, bound_ms, resolve, step_ms

PAGES, PAGE_SIZE, LENGTH = 3, 64, 150


def walk_bound_ms(config, B: int, length: int, quantized: bool
                  ) -> tuple[float, str]:
    """The least time of one walk over the layers (see the docstring)."""
    Hq, Hkv, D = config.num_heads, config.num_kv_heads, config.head_dim
    elem = 1 if quantized else 2
    per_layer = (2 * B * length * Hkv * D * elem
                 + (2 * B * length * Hkv * 4 if quantized else 0)
                 + 2 * B * Hkv * D * 2 + 2 * B * Hq * D * 2)
    flops = 4.0 * B * Hq * (length + 1) * D
    return bound_ms(per_layer * config.num_layers,
                    flops * config.num_layers)


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="bench-1b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--walks", default="5,20",
                    help="the two lengths, in walks over the layers")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    show = Rows(dev)
    cfg = get_config(args.config)
    B, L = args.batch, cfg.num_layers
    quantized = os.environ.get("TK_QUANT", "1") == "1"
    cache = PagedKVCache.create(cfg, B, B * PAGES + 1, PAGE_SIZE,
                                max_pages_per_row=PAGES, quantized=quantized,
                                device=dev)
    cache.page_table.copy_((1 + torch.arange(B * PAGES, device=dev,
                                             dtype=torch.int32))
                           .reshape(B, PAGES))
    cache.lengths.fill_(LENGTH)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    kc = torch.randn((B, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                     device=dev).to(torch.bfloat16)

    def call(i: int) -> None:
        q.copy_(paged_attention_append(q, kc, kc, cache, cache.lengths,
                                       i % L, pages=PAGES))

    w1, w2 = (int(w) for w in args.walks.split(","))
    show(f"time_append_kernel: kernel B append mode, {cfg.name}, B={B}, "
         f"{PAGES} pages of {PAGE_SIZE}, {LENGTH} tokens a row, quantized="
         f"{quantized}, chained calls over the {L} layers, {w1} and {w2} "
         f"walks, on {dev}")
    per_call = step_ms(call, dev, w1 * L, w2 * L)
    b_ms, by = walk_bound_ms(cfg, B, LENGTH, quantized)
    walk = per_call * L
    show(f"  {per_call * 1e3:.1f} us/call, {walk:.3f} ms per {L}-layer walk;"
         f" H100 bound {b_ms:.4f} ms per walk (by {by}, {b_ms / walk:.0%} "
         "of it); DMA-only cut-down: no counterpart")
    return dict(us_per_call=per_call * 1e3, walk_ms=walk, bound_ms=b_ms,
                quantized=quantized)


if __name__ == "__main__":
    main()
