"""Decode-step component attribution by ablation, the twin of the
reference's tools/profile_step.py.

:func:`step_variant` is a faithful copy of the gather branch of
models/llama.decode_step_paged (kernel B's append mode, then one write of
every layer's k/v) with one component removable per variant, as the
reference's; each variant is timed on the device and its delta from
``full`` printed:

- ``full``: the step;
- ``no_attn``: q stands in for the attention output (no kernel B);
- ``no_write``: no pool write (lengths still advance);
- ``no_lm_head``: the final-norm hidden states instead of the logits (and
  no advance, as the reference's);
- ``trunk_only``: no attention, no write and no lm head;
- ``mm_only``: no attention and no write;
- ``mm_scan_only``: the fused matmuls alone, one chain per layer (wqkv,
  wo, wgu, w_down) and the lm head: the weight stream's floor;
- ``sampling``: the batched sampler (models/sampling.sample_batched) alone
  on random [B, V] logits at temperature 0.7, top-p 0.9.

``unroll4`` is the reference's ``lax.scan(unroll=4)`` over the layers, an
XLA setting: the port's layer loop is Python, and on the card a decode
step is one CUDA graph, so there is nothing to unroll. The nearest thing
the port has is the K = 4 fused tick, whose graph replay chip_smoke.py's
``profile`` phases time (tools/trace_step.py); ``unroll4`` here prints
that it has no counterpart and times nothing.

Timing: card.step_ms, i.e. on the card mm_micro's ``device_ms`` (the
variant's calls captured at two lengths into CUDA graphs and
differenced: the counterpart of the reference's two-loop RTT solve). Each
call restarts the rows at ``PROF_LEN`` tokens, so every call does the same
work.

    python -m p2p_llm_chat_tpu_torch.tools.profile_step [variant ...] [--device cuda|cpu]

Env, as the reference's: ``PROF_CONFIG`` (bench-1b), ``PROF_SLOTS``
(32), ``PROF_WINDOW`` (192), ``PROF_KV_QUANT`` (int8 | "", default int8),
``PROF_STEPS`` (64); and ``PROF_LEN`` (64, the tokens each row holds in
the pool, as the reference's fixed 64).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from ..models import family_for, llama
from ..models.configs import get_config
from ..models.layers import rms_norm
from ..models.quant import mm
from ..ops.paged_attention import paged_attention_append
from ..ops.paged_kv import PagedKVCache, write_decode_burst
from .card import Rows, add_device_arg, resolve, step_ms

# The reference's variants (its default list first), each a step_variant
# but "sampling" and "unroll4".
DEFAULT_VARIANTS = ("full", "no_attn", "no_write", "no_lm_head",
                    "trunk_only", "sampling", "unroll4")
VARIANTS = DEFAULT_VARIANTS + ("mm_only", "mm_scan_only")
_SKIPS = {  # variant: (skip attention, skip the write, skip the lm head)
    "full": (False, False, False),
    "no_attn": (True, False, False),
    "no_write": (False, True, False),
    "no_lm_head": (False, False, True),
    "trunk_only": (True, True, True),
    "mm_only": (True, True, False),
}
NO_COUNTERPART = {
    "unroll4": "the reference's lax.scan unroll over the layers is an XLA "
               "setting; the port's layer loop is Python and a decode step "
               "is one CUDA graph on the card, so there is nothing to "
               "unroll (the nearest thing, the K = 4 fused tick, is timed "
               "by chip_smoke.py's profile phases)",
}


def mm_scan_only(params: dict, config, tokens: torch.Tensor) -> torch.Tensor:
    """The fused matmuls alone (no norms, rope, attention or write): per
    layer wqkv, wo on its q columns, wgu, w_down on its gate half, then
    the lm head; f32 [B, 1, V]."""
    h = params["embed"][tokens]
    H, E = h.shape[-1], config.intermediate_size
    layers = params["layers"]
    for li in range(config.num_layers):
        a = mm(h, layers["wqkv"], li)
        h1 = mm(a[..., :config.q_dim].contiguous(), layers["wo"], li)
        g = mm(h1, layers["wgu"], li)
        h = mm(g[..., :E].contiguous(), layers["w_down"], li)[..., :H]
    lm_head = (params["embed"].T if config.tie_embeddings
               else params["lm_head"])
    return mm(h, lm_head).float()


def step_variant(params: dict, config, tokens: torch.Tensor,
                 cache: PagedKVCache, *, pages: int,
                 variant: str = "full"):
    """One decode step of every row (tokens [B, 1] at position
    ``cache.lengths``) with ``variant``'s component removed (see the
    module's docstring). Returns (logits [B, 1, V] f32, or for
    ``no_lm_head`` / ``trunk_only`` the final-norm hidden states [B, 1, H]
    f32; the cache, written and advanced in place as the variant does).
    ``variant`` ``full`` is ``decode_step_paged``'s gather branch with
    every row active."""
    if variant in NO_COUNTERPART:
        raise ValueError(f"{variant}: no counterpart on the port: "
                         f"{NO_COUNTERPART[variant]}")
    if variant == "mm_scan_only":
        return mm_scan_only(params, config, tokens), cache
    if variant not in _SKIPS:
        raise ValueError(f"unknown variant {variant!r}; step variants are "
                         f"{', '.join(_SKIPS)} and mm_scan_only")
    skip_attn, skip_write, skip_lm_head = _SKIPS[variant]
    B = tokens.shape[0]
    layers = params["layers"]
    rope = llama._rope(config, cache.lengths[:, None])
    h = llama._embed(params, tokens)
    k_steps, v_steps = [], []
    for li in range(config.num_layers):
        q, k, v = llama._attn_qkv(h, layers, li, config, rope)
        k0, v0 = k[:, 0].contiguous(), v[:, 0].contiguous()
        if skip_attn:
            attn = q[:, 0]
        else:
            attn = paged_attention_append(q[:, 0].contiguous(), k0, v0,
                                          cache, cache.lengths, li,
                                          pages=pages)
        h = llama._post_attn(h, attn[:, None], layers, li, config)
        k_steps.append(k0)
        v_steps.append(v0)
    if skip_lm_head:
        out = rms_norm(h, params["final_norm"], config.rms_norm_eps).float()
    else:
        out = llama._logits(params, config, h)
    inc = torch.full((B,), 0 if skip_lm_head else 1, dtype=torch.int32,
                     device=tokens.device)
    if not skip_write:
        write_decode_burst(cache, torch.stack(k_steps), torch.stack(v_steps),
                           inc)
    else:
        cache.lengths += inc
    return out, cache


def sampling_call(B: int, vocab: int, dev: torch.device):
    """The batched sampler alone on random [B, V] logits (temperature 0.7,
    top-p 0.9, an empty penalty ring): ``fn(i)`` for card.step_ms."""
    from ..models.sampling import sample_batched
    gen = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((B, vocab), generator=gen, device=dev)
    keys = torch.zeros((B, 2), dtype=torch.long, device=dev)
    keys[:, 0] = 2
    temp = torch.full((B,), 0.7, device=dev)
    top_k = torch.zeros((B,), dtype=torch.long, device=dev)
    top_p = torch.full((B,), 0.9, device=dev)
    ring = torch.full((B, 64), vocab, dtype=torch.long, device=dev)
    rp = torch.ones((B,), device=dev)

    def fn(_i: int = 0) -> None:
        _, k = sample_batched(logits, keys, temp, top_k, top_p, ring=ring,
                              rp=rp)
        keys.copy_(k)
    return fn


def prof_env() -> dict:
    """The PROF_* settings (the reference's names and defaults)."""
    return dict(config=os.environ.get("PROF_CONFIG", "bench-1b"),
                slots=int(os.environ.get("PROF_SLOTS", "32")),
                window=int(os.environ.get("PROF_WINDOW", "192")),
                kv_quant=os.environ.get("PROF_KV_QUANT", "int8") == "int8",
                steps=int(os.environ.get("PROF_STEPS", "64")),
                length=int(os.environ.get("PROF_LEN", "64")))


def make_cache(config, B: int, window: int, length: int, kv_quant: bool,
               dev: torch.device, dtype: torch.dtype = torch.bfloat16,
               page_size: int = 64) -> tuple[PagedKVCache, int]:
    """A paged pool of ``B`` rows, each with its own ``window // page_size``
    pages (ids 1 ..; 0 is the garbage page) and ``length`` tokens, as the
    reference's; the pool's contents are zeros (``dtype``: a bf16 pool's,
    the activations'). Returns (cache, pages)."""
    pages = -(-window // page_size)
    cache = PagedKVCache.create(config, B, B * pages + 1, page_size,
                                max_pages_per_row=pages, dtype=dtype,
                                quantized=kv_quant, device=dev)
    cache.page_table.copy_((1 + torch.arange(B * pages, device=dev,
                                             dtype=torch.int32))
                           .reshape(B, pages))
    cache.lengths.fill_(length)
    return cache, pages


def run(variants, *, config: str, slots: int, window: int, length: int,
        kv_quant: bool, steps: int, dev: torch.device,
        show=print) -> dict:
    """Time each variant (ms per step; None for one with no counterpart)
    on random int8 weights of ``config``; print a row for each and the
    attribution (full - variant). Returns {variant: ms}."""
    cfg = get_config(config)
    if length + 1 > window:
        raise ValueError(f"{length} tokens leave no slot in a {window}-token "
                         "window")
    params = family_for(cfg).init_params_quantized(cfg, seed=0, quant="int8",
                                                   device=dev)
    cache, pages = make_cache(cfg, slots, window, length, kv_quant, dev,
                              params["embed"].dtype)
    toks = torch.ones((slots, 1), dtype=torch.long, device=dev)
    n1 = max(4, steps // 4)
    n2 = max(steps, 2 * n1)
    show(f"profile_step: {cfg.name}, {cfg.num_layers} layers, int8 weights, "
         f"{'int8' if kv_quant else 'bf16'} pool, B={slots}, window {window} "
         f"({pages} pages), {length} tokens a row; {n1} and {n2} calls a "
         f"variant, on {dev}")
    out: dict = {}
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v}")
        if v in NO_COUNTERPART:
            show(f"{v:14s} not run: no counterpart on the port ("
                 f"{NO_COUNTERPART[v]})")
            out[v] = None
            continue
        if v == "sampling":
            fn = sampling_call(slots, cfg.vocab_size, dev)
            label = f"sampling [B,{cfg.vocab_size}] alone"
        else:
            def fn(_i: int = 0, v=v) -> None:
                cache.lengths.fill_(length)
                step_variant(params, cfg, toks, cache, pages=pages,
                             variant=v)
            label = v
        out[v] = step_ms(fn, dev, n1, n2)
        show(f"{label:28s} {out[v]:8.3f} ms/step")
    full = out.get("full")
    if full:
        show("attribution (full - variant):")
        for v, ms in out.items():
            if v in ("full", "sampling") or ms is None:
                continue
            show(f"  {v:24s} {full - ms:8.3f} ms")
    return out


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(VARIANTS)} (default: "
                    f"{' '.join(DEFAULT_VARIANTS)})")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    return run(args.variants or DEFAULT_VARIANTS, dev=dev, show=Rows(dev),
               **prof_env())


if __name__ == "__main__":
    main()
