"""Ring attention and sequence-parallel decode over the ``sp`` axis, the
port of p2p_llm_chat_tpu/parallel/ring.py on the port's :class:`~.mesh.Mesh`.

- **Prefill** (:func:`ring_prefill`): every rank of the ring runs the
  whole layer stack on its chunk of the prompt (``Sl = S / sp``
  positions, query ``i`` of rank ``my`` at ``my Sl + i``) while the
  chunks' k/v travel the ring by :meth:`Mesh.ppermute`, one hop a step.
  Hop ``t`` holds the chunk of rank ``src = my - t`` (mod sp), keys at
  ``src Sl + j``: that is kernel D's offset semantics, one call at
  ``q_offset = (my - src) Sl`` (the diagonal chunk at 0, every earlier
  chunk wholly visible), and a chunk from a later rank is wholly masked,
  so its compute is skipped while its k/v still move on. Each hop's call
  returns its log-sum-exp beside its output, and the hops merge in f32
  as the reference's ``_online_update`` does.
- **Decode** (:func:`sp_decode_step`): the cache stays split over the
  sequence. The rank that owns slot ``lengths[b]`` writes the step's
  k/v there; every rank attends its shard through kernel B's pool mode
  over the dense cache (``dense_attention(return_lse=True)``) at local
  lengths ``clamp(lengths + 1 - my Sl, 0, Sl)`` — a shard past a row's
  length has 0 slots for it and gives output 0, log-sum-exp -inf, weight
  0 — and the partials merge over ``sp`` in f32: one all-reduce of the
  max, then one of the weighted outputs and weights together (the
  reference's ``pmax`` and two ``psum``s).
- **sp x tp**: heads and the FFN width are cut over ``tp`` inside the
  ring (:data:`RING_RULES`: the embedding and lm_head whole), so each
  rank rings its own kv heads and one all-reduce over ``tp`` follows
  ``wo`` and one ``w_down`` (the counterparts of the reference's
  ``_attn_qkv_local`` and ``_post_attn_tp`` are models/llama.py's
  ``_attn_qkv`` and ``_post_attn`` under the rank's
  :class:`~.sharding.Split`, whose config holds the rank's head counts).
- **sp x ep** (long-context Mixtral): the expert stacks are cut over
  ``ep``; every rank of an ep group holds the same chunk, routes it alike
  and runs its own experts' buckets (:func:`moe_ring_mlp_fn`), and one
  all-reduce over ``ep`` combines.

Weights: :func:`shard_ring_params` cuts a whole tree for a rank. Where
the port differs from the reference on purpose: the reference's
``assert``s are ``ValueError``s; the logits come back for the rank's
chunk only ([B, Sl, V], as the reference's out_specs shard them); and the
cache a rank returns is a :class:`~..models.llama.KVCache` of its
sequence shard ([L, B, Sl, Hkv / tp, D], its slot axis rounded up to a
page as the port's caches are, ``max_seq = Sl``) whose ``lengths`` are
the rows' global lengths, as the reference's sharded cache's are.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import llama
from ..models.configs import ModelConfig
from ..models.llama import KVCache
from ..ops.dense_attention import cache_slots, dense_attention
from ..ops.prefill_attention import prefill_attention
from .mesh import Mesh
from .sharding import DEFAULT_RULES, Split, shard_model, tree_specs

# The ring's logical rules: attention and MLP tp-cut as usual, the
# embedding and lm_head whole (h is whole on every tp rank after each
# block's all-reduce, and every rank projects the full vocabulary).
RING_RULES = dict(DEFAULT_RULES, vocab=None, act_vocab=None)


def ring_param_specs(axes_tree) -> object:
    """The spec tree of the ring's parameters (a family's ``param_axes``
    under :data:`RING_RULES`)."""
    return tree_specs(axes_tree, RING_RULES)


def ring_split(config: ModelConfig, mesh: Optional[Mesh]
               ) -> Optional[Split]:
    """What a rank of the ring holds: the heads and FFN cut over ``tp``,
    the experts over ``ep``, the vocabulary whole."""
    return Split.of(config, mesh, RING_RULES)


def shard_ring_params(params: dict, config: ModelConfig, mesh: Mesh,
                      device: Optional[str | torch.device] = None) -> dict:
    """This rank's fused tree for the ring from the whole one (plain:
    cut on the unfused ``wq``/``wk``/``wv`` and ``w_gate``/``w_up``
    leaves, then fused to ``[q_r | k_r | v_r]``; int8 / int4: quantized
    whole, cut after, parallel/sharding.cut_leaf)."""
    return shard_model(params, config, mesh, device, rules=RING_RULES)


def _check_mesh(config: ModelConfig, mesh: Mesh, mlp_fn) -> int:
    """The reference's asserts, as ValueErrors; returns sp."""
    sp, tp, ep = (mesh.shape[a] for a in ("sp", "tp", "ep"))
    if mesh.size != sp * tp * ep:
        raise ValueError(f"ring path runs over sp (x tp | x ep) only (mesh "
                         f"{dict(mesh.shape)}); set other axes to 1")
    if tp > 1 and mlp_fn is not None:
        raise ValueError("MoE composes with the ring via ep "
                         "(moe_ring_mlp_fn), not tp")
    if ep > 1 and mlp_fn is None:
        raise ValueError("an ep axis shards experts; pass "
                         "moe_ring_mlp_fn(config, 'ep', mesh)")
    if config.num_kv_heads % tp:
        raise ValueError(f"{config.num_kv_heads} kv heads cannot be cut "
                         f"over tp={tp}")
    if not mesh.coords:
        raise ValueError("this rank is not in the ring's mesh")
    return sp


def _local(config: ModelConfig, mesh: Mesh) -> tuple:
    split = ring_split(config, mesh)
    return (config, None) if split is None else (split.config, split)


def moe_ring_mlp_fn(config: ModelConfig, ep_axis: Optional[str],
                    mesh: Optional[Mesh] = None):
    """The sparse-MoE MLP of the ring's layers (``mlp_fn(x, layers,
    li)``), experts cut over ``ep_axis`` of ``mesh`` (None: every rank
    holds every expert). A rank's chunk is the same on every rank of its
    ep group, so routing and the buckets' slots, over the GLOBAL expert
    ids, agree without a word; each rank fills and runs only its local
    experts' buckets, a selection of another rank's expert reads 0, and
    the weighted sums are all-reduced over ``ep``
    (models/mixtral.moe_mlp under the rank's split). Dropless:
    ``C = T``, as the reference's."""
    from ..models.mixtral import moe_mlp
    split = None
    if ep_axis is not None:
        if ep_axis != "ep" or mesh is None:
            raise ValueError("moe_ring_mlp_fn cuts experts over 'ep' of a "
                             "mesh: moe_ring_mlp_fn(config, 'ep', mesh)")
        split = ring_split(config, mesh)

    def fn(x: torch.Tensor, layers: dict, li: int) -> torch.Tensor:
        return moe_mlp(x, layers["router"], layers.get("w_gate"),
                       layers.get("w_up"), layers["w_down"],
                       config.num_experts_per_tok, None,
                       w_gu=layers.get("wgu_e"), layer=li, split=split)
    return fn


def _merge_hop(out: torch.Tensor, lse: torch.Tensor, o: torch.Tensor,
               lse_o: torch.Tensor) -> tuple:
    """Two attentions of the same queries over disjoint keys, each
    normalised, merged by their log-sum-exps (f32): out [B, S, Hq, D],
    lse [B, Hq, S]."""
    m = torch.maximum(lse, lse_o)
    a, b = torch.exp(lse - m), torch.exp(lse_o - m)
    den = a + b
    wa = (a / den).transpose(1, 2)[..., None]
    wb = (b / den).transpose(1, 2)[..., None]
    return out * wa + o.float() * wb, m + torch.log(den)


def _ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mesh: Mesh, sp: int, my: int, Sl: int) -> torch.Tensor:
    """Causal ring attention of one layer: this rank's chunk q/k/v
    [B, Sl, H*, D] (global positions ``my Sl + i``). The k/v chunks make
    ``sp - 1`` hops; hop ``t`` holds rank ``(my - t) % sp``'s. Returns
    [B, Sl, Hq, D] in q.dtype."""
    out, lse = prefill_attention(q, k, v, 0, return_lse=True)
    out = out.float()
    kv = torch.stack((k, v))
    for t in range(1, sp):
        kv = mesh.ppermute(kv, "sp")
        src = (my - t) % sp
        if src > my:                    # every key after every query
            continue
        o, lse_o = prefill_attention(q, kv[0], kv[1], (my - src) * Sl,
                                     return_lse=True)
        out, lse = _merge_hop(out, lse, o, lse_o)
    return out.to(q.dtype)


def ring_prefill(params: dict, config: ModelConfig, tokens: torch.Tensor,
                 prompt_lens: torch.Tensor, mesh: Mesh,
                 mlp_fn=None) -> tuple[torch.Tensor, KVCache]:
    """Sequence-parallel prefill: the whole layer stack on this rank's
    chunk of the prompt with ring attention (kernel D with its
    log-sum-exp on every hop).

    ``params``: this rank's tree (:func:`shard_ring_params`); tokens
    [B, S] right-padded (the whole prompt, the same on every rank; S
    divisible by sp); prompt_lens [B]. Returns (logits [B, Sl, V] f32 of
    this rank's chunk, positions ``my Sl ..``; the rank's cache, k/v
    [L, B, Sl(+pad), Hkv / tp, D] of its chunk, lengths = prompt_lens,
    ``max_seq = Sl``, ready for :func:`sp_decode_step`: budget S for
    prompt and generation). Numerics are models/llama.prefill's."""
    sp = _check_mesh(config, mesh, mlp_fn)
    B, S = tokens.shape
    if S % sp:
        raise ValueError(f"seq {S} not divisible by sp={sp}")
    Sl = S // sp
    my = mesh.index("sp")
    local, split = _local(config, mesh)
    dev = tokens.device
    layers = params["layers"]
    positions = (my * Sl + torch.arange(Sl, device=dev))[None].expand(B, Sl)
    rope = llama._rope(local, positions)
    h = params["embed"][tokens[:, my * Sl:(my + 1) * Sl]]
    shape = (local.num_layers, B, cache_slots(Sl), local.num_kv_heads,
             local.head_dim)
    cache = KVCache(k=torch.zeros(shape, dtype=h.dtype, device=dev),
                    v=torch.zeros(shape, dtype=h.dtype, device=dev),
                    lengths=prompt_lens.to(dev, torch.int32).clone(),
                    max_seq=Sl)
    for li in range(local.num_layers):
        q, k, v = llama._attn_qkv(h, layers, li, local, rope)
        cache.k[li, :, :Sl] = k
        cache.v[li, :, :Sl] = v
        attn = _ring_attend(q, k, v, mesh, sp, my, Sl)
        h = llama._post_attn(h, attn, layers, li, local, mlp_fn, split)
    return llama._logits(params, local, h), cache


def _sp_merge(o: torch.Tensor, lse: torch.Tensor, mesh: Mesh
              ) -> torch.Tensor:
    """The shards' decode partials o [B, Hq, D] (normalised over each
    shard) merged by their log-sum-exps lse [B, Hq] over ``sp``, in f32:
    an all-reduce of the max, then one of the weighted outputs with the
    weights beside them. A shard with no slot for a row (lse -inf) weighs
    0."""
    D = o.shape[-1]
    m = mesh.all_reduce(lse.clone(), "sp", op="max")
    w = torch.where(torch.isneginf(lse), torch.zeros_like(lse),
                    torch.exp(lse - m))
    part = torch.cat([o.float() * w[..., None], w[..., None]], dim=-1)
    part = mesh.all_reduce(part, "sp")
    return (part[..., :D] / part[..., D:]).to(o.dtype)


def sp_decode_step(params: dict, config: ModelConfig, tokens: torch.Tensor,
                   cache: KVCache, mesh: Mesh,
                   active: Optional[torch.Tensor] = None,
                   mlp_fn=None) -> tuple[torch.Tensor, KVCache]:
    """One decode step against a sequence-split cache (this rank's
    :func:`ring_prefill` cache), models/llama.decode_step's contract
    with its parked-row ``active`` semantics: row b writes global slot
    ``lengths[b]`` (on the one rank that holds it; a slot past the
    prompt budget is written nowhere) and attends slots
    ``[0, lengths[b]]``, each rank its shard through kernel B, the
    partials merged over ``sp``. tokens [B, 1]. Returns (logits
    [B, 1, V] f32, the same on every rank; the cache, lengths advanced
    where active, in place)."""
    sp = _check_mesh(config, mesh, mlp_fn)
    my = mesh.index("sp")
    Sl = cache.max_seq
    local, split = _local(config, mesh)
    B = tokens.shape[0]
    dev = tokens.device
    layers = params["layers"]
    lengths = cache.lengths
    rope = llama._rope(local, lengths[:, None])
    h = params["embed"][tokens]
    slot = lengths.long() - my * Sl
    own = ((slot >= 0) & (slot < Sl))[:, None, None]
    idx = slot.clamp(0, Sl - 1)
    rows = torch.arange(B, device=dev)
    local_len = (lengths + 1 - my * Sl).clamp(0, Sl).to(torch.int32)
    for li in range(local.num_layers):
        q, k, v = llama._attn_qkv(h, layers, li, local, rope)
        for c, x in ((cache.k, k), (cache.v, v)):
            c[li, rows, idx] = torch.where(own, x[:, 0].to(c.dtype),
                                           c[li, rows, idx])
        o, lse = dense_attention(q[:, 0].contiguous(), cache, local_len, li,
                                 window=Sl, return_lse=True)
        attn = _sp_merge(o, lse, mesh)[:, None]
        h = llama._post_attn(h, attn, layers, li, local, mlp_fn, split)
    logits = llama._logits(params, local, h)
    inc = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
           else active.to(device=dev, dtype=torch.int32))
    cache.lengths += inc
    return logits, cache
