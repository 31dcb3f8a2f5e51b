"""Pipeline parallelism over the ``pp`` axis (GPipe-style), the port of
p2p_llm_chat_tpu/parallel/pipeline.py on the port's :class:`~.mesh.Mesh`.

The layer stack is cut into ``pp`` contiguous stages: a rank holds
layers ``[s L/pp, (s+1) L/pp)`` and their cache
(parallel/sharding.stage_layers), stage 0 embeds, the last stage
projects, and the activations move stage to stage by
:meth:`Mesh.ppermute` along the chain while microbatches stream through.

- :func:`pp_prefill` runs the reference's schedule of ``M + pp - 1``
  ticks (M microbatches): at tick ``t`` stage ``s`` holds microbatch
  ``t - s`` when that is in ``[0, M)``, and at the tick's end hands it
  to stage ``s + 1``. Attention is kernel D, as the single-rank prefill.
- :func:`pp_decode_step` takes the one-token batch through the stages in
  ``pp`` ticks; attention is kernel B's pool mode over the stage's dense
  cache (ops/dense_attention.py), as ``llama.decode_step``.

Where the port differs from the reference on purpose: a stage computes
only on the ticks where it holds a real microbatch (the reference's
stages compute every tick, their bubble ticks' writes aimed out of range
and dropped: an XLA artefact with no effect on any output); the last
stage's logits reach every rank by a broadcast over ``pp`` (the
reference's ``psum`` of the other stages' zeros, the same values); the
reference's ``assert``s are ``ValueError``s; and :func:`pp_prefill` can
return only each row's last prompt position (``last_only``, as
``llama.prefill``), which keeps the broadcast small.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import llama
from ..models.configs import ModelConfig
from ..models.layers import attend_gqa_auto
from ..models.llama import KVCache, write_dense
from ..ops.dense_attention import cache_slots, dense_attention
from .mesh import Mesh


def _stage(config: ModelConfig, mesh: Mesh, params: dict) -> tuple:
    """(pp, this rank's stage index, layers per stage), after the
    reference's checks (as ValueErrors) and a check that ``params`` is a
    stage's tree."""
    pp = mesh.shape["pp"]
    if mesh.size != pp:
        raise ValueError(f"pipeline path runs over pp only (mesh "
                         f"{dict(mesh.shape)}); set other axes to 1")
    L = config.num_layers
    if L % pp:
        raise ValueError(f"{L} layers not divisible by pp={pp}")
    if not mesh.coords:
        raise ValueError("this rank is not in the pipeline's mesh")
    lead = params["layers"]["attn_norm"].shape[0]
    if lead != L // pp:
        raise ValueError(f"params hold {lead} layers, a stage {L // pp}: "
                         "pass this rank's stage (parallel/sharding."
                         "stage_layers)")
    return pp, mesh.index("pp"), L // pp


def _new_cache(config: ModelConfig, Lp: int, B: int, S: int,
               lengths: torch.Tensor, dtype, device) -> KVCache:
    shape = (Lp, B, cache_slots(S), config.num_kv_heads, config.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=lengths.to(device, torch.int32).clone(),
                   max_seq=S)


def pp_prefill(params: dict, config: ModelConfig, tokens: torch.Tensor,
               prompt_lens: torch.Tensor, mesh: Mesh,
               microbatches: Optional[int] = None, mlp_fn=None,
               last_only: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Pipeline-parallel prefill: ``llama.prefill``'s contract with the
    stack cut into ``pp`` stages and the batch streamed through as
    ``microbatches`` (default ``min(pp, B)``; B divisible by it).

    ``params``: this rank's stage (parallel/sharding.stage_layers);
    tokens [B, S] right-padded, prompt_lens [B], the same on every rank.
    Returns (logits [B, S, V] f32 — [B, 1, V] at each row's last prompt
    position with ``last_only`` — the same on every rank; this stage's
    cache, k/v [L/pp, B, S(+pad), Hkv, D], lengths = prompt_lens,
    ``max_seq = S``)."""
    pp, my, Lp = _stage(config, mesh, params)
    B, S = tokens.shape
    M = microbatches or min(pp, B)
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    per = B // M
    dev = tokens.device
    layers = params["layers"]
    dtype = params["embed"].dtype
    cache = _new_cache(config, Lp, B, S, prompt_lens, dtype, dev)
    rope = llama._rope(config, torch.arange(S, device=dev)[None].expand(
        per, S))
    lens = prompt_lens.to(dev).long()
    logits = torch.empty((B, 1 if last_only else S, config.vocab_size),
                         dtype=torch.float32, device=dev)
    slot = torch.empty((per, S, config.hidden_size), dtype=dtype,
                       device=dev)
    h = None
    for t in range(M + pp - 1):          # the reference's static schedule
        m = t - my                       # this stage's microbatch
        if 0 <= m < M:
            rows = slice(m * per, (m + 1) * per)
            if my == 0:
                h = params["embed"][tokens[rows]]
            for li in range(Lp):
                q, k, v = llama._attn_qkv(h, layers, li, config, rope)
                cache.k[li, rows, :S] = k
                cache.v[li, rows, :S] = v
                h = llama._post_attn(h, attend_gqa_auto(q, k, v, 0), layers,
                                     li, config, mlp_fn)
            if my == pp - 1:
                last = (lens[rows] - 1).clamp(min=0) if last_only else None
                logits[rows] = llama._logits(params, config, h, last)
        # Stage s hands microbatch t - s to stage s + 1 at the tick's end.
        send = my < pp - 1 and 0 <= m < M
        recv = my > 0 and 0 <= m + 1 < M
        if send or recv:
            got = mesh.ppermute(h if send else slot, "pp", wrap=False,
                                send=send, recv=recv)
            if recv:
                h = got
    return mesh.broadcast(logits, "pp", src=pp - 1), cache


def pp_decode_step(params: dict, config: ModelConfig, tokens: torch.Tensor,
                   cache: KVCache, mesh: Mesh,
                   active: Optional[torch.Tensor] = None,
                   mlp_fn=None) -> tuple[torch.Tensor, KVCache]:
    """One decode step against a stage's cache (:func:`pp_prefill`'s),
    ``llama.decode_step``'s contract with its parked-row ``active``
    semantics; the batch crosses the stages in ``pp`` ticks. tokens
    [B, 1]. Returns (logits [B, 1, V] f32, the same on every rank; the
    cache, lengths advanced where active, in place)."""
    pp, my, Lp = _stage(config, mesh, params)
    B = tokens.shape[0]
    dev = tokens.device
    layers = params["layers"]
    pos = cache.lengths[:, None]
    rope = llama._rope(config, pos)
    attend_len = cache.lengths + 1
    logits = torch.empty((B, 1, config.vocab_size), dtype=torch.float32,
                         device=dev)
    h = (params["embed"][tokens] if my == 0 else
         torch.empty((B, 1, config.hidden_size),
                     dtype=params["embed"].dtype, device=dev))
    for t in range(pp):
        if t == my:                      # the real activation is here
            for li in range(Lp):
                q, k, v = llama._attn_qkv(h, layers, li, config, rope)
                write_dense(cache, li, k, v, pos)
                attn = dense_attention(q[:, 0].contiguous(), cache,
                                       attend_len, li,
                                       window=cache.max_seq)[:, None]
                h = llama._post_attn(h, attn, layers, li, config, mlp_fn)
            if my == pp - 1:
                logits = llama._logits(params, config, h)
        send, recv = t == my and my < pp - 1, t == my - 1
        if send or recv:
            got = mesh.ppermute(h, "pp", wrap=False, send=send, recv=recv)
            if recv:
                h = got
    inc = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
           else active.to(device=dev, dtype=torch.int32))
    cache.lengths += inc
    return mesh.broadcast(logits, "pp", src=pp - 1), cache
