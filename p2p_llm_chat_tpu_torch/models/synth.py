"""Synthetic "quote-the-context" weights — the port of
p2p_llm_chat_tpu/models/synth.py.

A random-init model's greedy continuation repeats essentially no
n-grams, so prompt-lookup speculation never lands on it.
:func:`quote_params` builds a full-size random tree whose OUTPUT follows
a fixed successor map instead: near-orthogonal embeddings and an lm_head
that maps each token's embedding to its successor, with the successor
cycles laid inside the byte tokenizer's printable-ASCII ids. Every
forward still pays the full model compute (the transformer layers keep
their random weights, the residual-writing projections damped), while
the greedy output settles into a repeating printable phrase: n-gram
drafts land and a verify tick has something to accept. The logit margin
(~4 x hidden) leaves no near-ties for rounding to flip.

The construction is the reference's; the random bits are not (the
embedding is drawn from a ``torch.Generator`` seeded explicitly, where
the reference uses ``jax.random``). Tests that compare the two packages
carry the reference's weights across (models/convert.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .configs import ModelConfig
from .quant import QTensor, QTensor4, _quantize_leaf

# The byte tokenizer maps byte b to id b (specials live above 256).
_ASCII_LO, _ASCII_HI = 32, 127
_CYCLE = 16


def successor_map(vocab: int, mode: str = "quote") -> np.ndarray:
    """succ[t] for every token id (the reference's): printable ids cycle
    within the printable range, every other id funnels into it.
    ``"quote"``: blocks of ``_CYCLE`` consecutive ids, so the output
    repeats a 16-token phrase; ``"freeform"``: one seeded pseudo-random
    cycle over the whole printable range."""
    ids = np.arange(_ASCII_LO, _ASCII_HI)
    succ = np.empty(vocab, np.int64)
    succ[:] = _ASCII_LO + (np.arange(vocab) % len(ids))
    if mode == "freeform":
        order = np.random.default_rng(11).permutation(ids)
        succ[order] = np.roll(order, -1)
        return succ
    if mode != "quote":
        raise ValueError(f"successor_map mode must be quote|freeform, "
                         f"got {mode!r}")
    for start in range(0, len(ids), _CYCLE):
        block = ids[start: start + _CYCLE]
        succ[block] = np.roll(block, -1)
    return succ


def _successor_sum(emb: torch.Tensor, succ: np.ndarray, stray: np.ndarray,
                   weights: np.ndarray) -> torch.Tensor:
    """``out[j] = sum_{succ(t) = j} w_t emb[t]`` [V, H] f32, summed in one
    fixed order on every device: ``succ`` is one-to-one on the printable
    ids, and a stray ``t`` maps to ``_ASCII_LO + t % n`` (n printable ids),
    so the printable rows are placed and each residue class of the strays
    is summed over one axis of a [V / n, n, H] view. (``index_add_`` on the
    card accumulates with atomics, whose order, and so whose bits, vary
    from run to run and from process to process: ranks that each build
    the tree would hold different heads.)"""
    V, H = emb.shape
    n = _ASCII_HI - _ASCII_LO
    dev = emb.device
    out = torch.zeros((V, H), dtype=torch.float32, device=dev)
    out[torch.from_numpy(succ[_ASCII_LO:_ASCII_HI]).to(dev)] = \
        emb[_ASCII_LO:_ASCII_HI].float()
    cls = torch.zeros((-(-V // n) * n, H), dtype=torch.float32, device=dev)
    cls[:V] = emb
    cls[:V] *= torch.from_numpy(np.where(stray, weights, 0.0).astype(
        np.float32)).to(dev)[:, None]
    out[_ASCII_LO:_ASCII_HI] += cls.view(-1, n, H).sum(dim=0)
    return out


def quote_params(config: ModelConfig, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, quant: str = "int8",
                 mode: str = "quote",
                 device: Optional[torch.device | str] = None,
                 mesh=None) -> dict:
    """The family's random fused tree at ``quant`` (``int8``, ``int4`` or
    ``""``; seed ``seed``) on ``device`` (the card unless the CPU is
    asked for), with ``wo`` and ``w_down`` damped by 0.1, the embedding
    N(0, 1) from a generator seeded with 7, and an untied lm_head built
    from :func:`successor_map`: ``lm_head[:, j] = 4 sum_{succ(t) = j}
    w_t emb[t]`` with ``w_t = 1`` for printable tokens and 1/sqrt(strays
    per column) for the rest (the reference's construction, on the
    device: at 8B dims the head is 2.1 GB in f32). ``mesh``: this rank's
    shard of the same tree, the layers drawn a layer at a time
    (llama.random_tree) and the embedding and head built whole, then
    cut (parallel/sharding.cut_leaf)."""
    from ..parallel.sharding import Split, cut_leaf
    from . import family_for
    if config.tie_embeddings:
        raise ValueError("quote workload needs an untied lm_head")
    device = resolve_device(device)
    params = family_for(config).init_params_quantized(
        config, seed=seed, dtype=dtype, quant=quant, device=device,
        mesh=mesh)
    split = Split.of(config, mesh)
    layers = dict(params["layers"])
    for name in ("wo", "w_down"):
        leaf = layers[name]
        layers[name] = (type(leaf)(q=leaf.q, s=leaf.s * 0.1)
                        if isinstance(leaf, (QTensor, QTensor4))
                        else leaf * 0.1)
    params = dict(params, layers=layers)
    params.pop("lm_head", None)
    params.pop("embed", None)
    V, H = config.vocab_size, config.hidden_size
    gen = torch.Generator(device=device).manual_seed(7)
    emb = torch.randn((V, H), generator=gen, dtype=torch.float32,
                      device=device)
    succ = successor_map(V, mode=mode)
    stray = np.ones(V, bool)
    stray[_ASCII_LO:_ASCII_HI] = False
    per_col = max(1, int(stray.sum()) // (_ASCII_HI - _ASCII_LO))
    weights = np.where(stray, 1.0 / np.sqrt(per_col), 1.0).astype(np.float32)
    lm = _successor_sum(emb, succ, stray, weights).T.contiguous() * 4.0
    params["embed"] = cut_leaf("embed", emb.to(dtype), split)
    del emb
    params["lm_head"] = cut_leaf(
        "lm_head", _quantize_leaf(lm, quant) if quant else lm.to(dtype),
        split)
    return params
