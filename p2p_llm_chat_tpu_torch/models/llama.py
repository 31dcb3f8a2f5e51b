"""llama-family decoder (3.x dense models), the port of
p2p_llm_chat_tpu/models/llama.py for the paged decode path: random int8 /
int4 init, fused projections, whole-prompt and continuation (chunk /
prefix-suffix) prefill, the pooled sequence embedding of /api/embed
(:func:`embed_pooled` over the :func:`hidden_states` trunk), the paged
decode step in both of the
reference's orderings (attend-then-write, write-then-attend) and its
fused K-step form (:func:`decode_fused`), the speculative verify forwards
over the pool (:func:`verify_step_paged` for a draft chain,
:func:`verify_tree_paged` for a node tree), with the
reference's ``mlp_fn`` hook through which the mixtral family
(models/mixtral.py) plugs its sparse-MoE MLP in.

Params keep the reference's tree and layouts (``embed`` [V, H], stacked
``layers`` with fused ``wqkv`` [L, H, Q+2KV] and ``wgu`` [L, H, 2E] as
QTensors or plain tensors, ``final_norm``, ``lm_head`` [H, V]), so
models/convert.py carries weights across without transposes. A Python
loop over layers takes the place of ``lax.scan``; each projection reads
the stacked weight at the layer index (kernel A gets the offset pointer,
never a slice copy).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..ops import paged_attention as pa
from ..ops.paged_attention import (check_impl, paged_attention,
                                   paged_attention_append,
                                   paged_attention_verify_append)
from ..ops.paged_kv import (PagedKVCache, write_decode, write_decode_burst,
                            write_decode_multi,
                            write_decode_multi_all_layers)
from ..utils.device import resolve_device
from .configs import ModelConfig
from .layers import (apply_rope_tables, attend_gqa_auto, rms_norm,
                     rope_frequencies, rope_tables)
from .quant import QTensor, QTensor4, _quantize_leaf, mm, stream_bufs


def init_params_quantized(config: ModelConfig, seed: int = 0,
                          dtype: torch.dtype = torch.bfloat16,
                          quant: str = "int8",
                          device: Optional[torch.device | str] = None
                          ) -> dict:
    """Random init (scaled normal, std = hidden^-0.5; embeddings N(0, 1))
    generated layer by layer on ``device`` (the card unless the CPU is
    asked for; see utils/device.py) from one ``torch.Generator``
    and ALREADY FUSED (``wqkv = [q|k|v]``, ``wgu = [gate|up]``), so at
    most one layer's f32 weights exist next to the stacked tree — the
    8B int8 model (~7.5 GB + a 1 GB bf16 embedding) is built on the card
    directly. ``quant``: ``int8`` (QTensor leaves), ``int4`` (QTensor4
    leaves, group-wise; a leaf whose contraction cannot group keeps int8,
    as in the reference) or ``""`` (plain ``dtype`` leaves). The
    distribution is the reference's; the random stream is not (torch and
    jax generators differ)."""
    E = config.intermediate_size
    dims = {
        "wqkv": (config.hidden_size, config.q_dim + 2 * config.kv_dim),
        "wo": (config.q_dim, config.hidden_size),
        "wgu": (config.hidden_size, 2 * E),
        "w_down": (E, config.hidden_size),
    }
    return random_tree(config, dims, {}, seed, dtype, quant, device)


def random_tree(config: ModelConfig, dims: dict, plain_dims: dict,
                seed: int, dtype: torch.dtype, quant: str,
                device: Optional[torch.device | str]) -> dict:
    """The layer-by-layer random build shared by both families: stacked
    ``dims`` leaves (quantized at ``quant``; a 3-D shape is an expert
    stack, generated and quantized one expert at a time, so one layer of
    mixtral-8x7b's [8, 4096, 28672] experts never exists in f32 at once
    — int8 scales are per (expert, column) and int4 scales per (expert,
    group, column), so the result is the same), then stacked
    ``plain_dims`` leaves in ``dtype``, then the embedding and an
    untied lm_head."""
    if quant not in ("int8", "int4", ""):
        raise ValueError(f"quant must be int8, int4 or '', got {quant!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, H = config.num_layers, config.hidden_size
    std = H ** -0.5

    def normal(shape, scale=std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    layers: dict = {
        "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, H), dtype=dtype, device=device),
    }
    for name, shape in dims.items():
        layers[name] = (stream_bufs(L, shape, quant, device) if quant else
                        torch.empty((L, *shape), dtype=dtype, device=device))
    for name, shape in plain_dims.items():
        layers[name] = torch.empty((L, *shape), dtype=dtype, device=device)
    for li in range(L):
        for name, shape in dims.items():
            expert = len(shape) == 3
            for idx in ([(li, e) for e in range(shape[0])] if expert
                        else [(li,)]):
                w = normal(shape[-2:])
                if quant:
                    qt = _quantize_leaf(w, quant, expert=expert)
                    layers[name].q[idx] = qt.q
                    layers[name].s[idx] = qt.s
                else:
                    layers[name][idx] = w
                del w
        for name, shape in plain_dims.items():
            layers[name][li] = normal(shape)
    params = {
        "embed": normal((config.vocab_size, H), scale=1.0),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
    }
    if not config.tie_embeddings:
        head = normal((H, config.vocab_size))
        params["lm_head"] = _quantize_leaf(head, quant) if quant else head
    return params


def _ndim(leaf) -> int:
    return leaf.q.ndim if isinstance(leaf, (QTensor, QTensor4)) else leaf.ndim


def fuse_params(params: dict) -> dict:
    """Concatenate per-layer ``wq|wk|wv -> wqkv`` and ``w_gate|w_up`` on
    the output axis: ``wgu`` for dense [L, H, E] leaves, ``wgu_e`` for
    per-expert [L, NE, H, F] ones (int8 scales ride their columns, and
    int4's group scales ``[..., ng, O]`` concatenate the same way). No-op
    on an already fused tree."""
    layers = params["layers"]
    if "wqkv" in layers:
        return params

    def cat(ws):
        if isinstance(ws[0], (QTensor, QTensor4)):
            return type(ws[0])(q=torch.cat([w.q for w in ws], dim=-1),
                               s=torch.cat([w.s for w in ws], dim=-1))
        return torch.cat(ws, dim=-1)

    fused = {k: v for k, v in layers.items()
             if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
    fused["wqkv"] = cat([layers["wq"], layers["wk"], layers["wv"]])
    gu = "wgu" if _ndim(layers["w_gate"]) == 3 else "wgu_e"
    fused[gu] = cat([layers["w_gate"], layers["w_up"]])
    out = dict(params)
    out["layers"] = fused
    return out


@functools.lru_cache(maxsize=16)
def _inv_freq(config: ModelConfig, device: str) -> torch.Tensor:
    """The cached rope frequencies. On the card the table is complete
    before it is returned: the serving loop and an embed call on its own
    stream (serve/engine.TorchEngine.embed) both read it."""
    t = rope_frequencies(config, device)
    if t.is_cuda and not torch.cuda.is_current_stream_capturing():
        torch.cuda.current_stream(t.device).synchronize()
    return t


def _rope(config: ModelConfig, positions: torch.Tensor):
    """The step's rope cos/sin tables, built once for every layer."""
    return rope_tables(positions, _inv_freq(config, str(positions.device)))


def _attn_qkv(h: torch.Tensor, layers: dict, li: int, config: ModelConfig,
              rope: tuple[torch.Tensor, torch.Tensor]):
    """Pre-norm + fused q/k/v projection + rope (``rope`` = cos/sin from
    :func:`_rope`). h: [B,S,H] -> q [B,S,Hq,D], k/v [B,S,Hkv,D]."""
    B, S, _ = h.shape
    x = rms_norm(h, layers["attn_norm"][li], config.rms_norm_eps)
    qkv = mm(x, layers["wqkv"], li)
    Q, KV = config.q_dim, config.kv_dim
    q = qkv[..., :Q].reshape(B, S, config.num_heads, config.head_dim)
    k = qkv[..., Q:Q + KV].reshape(B, S, config.num_kv_heads,
                                   config.head_dim)
    v = qkv[..., Q + KV:].reshape(B, S, config.num_kv_heads,
                                  config.head_dim)
    return (apply_rope_tables(q, *rope), apply_rope_tables(k, *rope),
            v.contiguous())


def _post_attn(h: torch.Tensor, attn: torch.Tensor, layers: dict, li: int,
               config: ModelConfig, mlp_fn=None) -> torch.Tensor:
    """Output projection + residual + MLP + residual. The MLP is the
    dense SwiGLU, or ``mlp_fn(x, layers, li)`` (models/mixtral.py plugs
    its sparse-MoE MLP in here)."""
    B, S = attn.shape[:2]
    h = h + mm(attn.reshape(B, S, config.q_dim), layers["wo"], li)
    x = rms_norm(h, layers["mlp_norm"][li], config.rms_norm_eps)
    if mlp_fn is not None:
        return h + mlp_fn(x, layers, li)
    gu = mm(x, layers["wgu"], li)
    E = gu.shape[-1] // 2
    g = torch.nn.functional.silu(gu[..., :E]) * gu[..., E:]
    return h + mm(g, layers["w_down"], li)


def _lm_head(params: dict, config: ModelConfig, h: torch.Tensor
             ) -> torch.Tensor:
    """f32 logits of final-norm hidden states."""
    lm_head = (params["embed"].T if config.tie_embeddings
               else params["lm_head"])
    return mm(h, lm_head).float()


def _logits(params: dict, config: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], config.rms_norm_eps)
    return _lm_head(params, config, h)


def hidden_states(params: dict, config: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, store, q_offset: int,
                  mlp_fn=None, last_idx: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The decoder trunk over ``tokens`` [R, S] at ``positions`` (the
    reference's ``hidden_states``): embed, every layer, final norm. Each
    layer's k/v go to ``store(li, k, v)``, which returns the k/v its
    queries attend over (query i at absolute position ``q_offset + i``,
    causally; kernel D on the card). Returns the final-norm hidden states
    [R, S, H], or [R, 1, H] at chunk-local ``last_idx`` (gathered before
    the norm, which is per position)."""
    layers = params["layers"]
    rope = _rope(config, positions)
    h = params["embed"][tokens]
    for li in range(config.num_layers):
        q, k, v = _attn_qkv(h, layers, li, config, rope)
        k, v = store(li, k, v)
        h = _post_attn(h, attend_gqa_auto(q, k, v, q_offset), layers, li,
                       config, mlp_fn)
    if last_idx is not None:
        R = tokens.shape[0]
        idx = last_idx.to(h.device).long()
        h = h[torch.arange(R, device=h.device), idx][:, None]
    return rms_norm(h, params["final_norm"], config.rms_norm_eps)


def _stack(params: dict, config: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor, store, q_offset: int, mlp_fn,
           last_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`hidden_states` then the lm_head: the logits at chunk-local
    ``last_idx`` ([R, 1, V] f32), or at every position ([R, S, V])."""
    return _lm_head(params, config, hidden_states(
        params, config, tokens, positions, store, q_offset, mlp_fn,
        last_idx))


def embed_pooled(params: dict, config: ModelConfig, tokens: torch.Tensor,
                 lens: torch.Tensor, *, mlp_fn=None) -> torch.Tensor:
    """Sequence embeddings (the reference's ``embed_pooled``, the backend
    of ``POST /api/embed``): the length-masked mean of the final-norm
    hidden states in f32, divided by ``max(len, 1)``, L2-normalised with
    a 1e-9 floor.

    tokens: [R, S] right-padded; lens: [R]. Causal attention from
    position 0 over the bucket (kernel D at offset 0 on the card) with a
    no-op KV store; pads sit after each text, so no real position sees
    them, and they are masked out of the mean. Returns [R, H] f32 unit
    vectors. ``mlp_fn``: see :func:`_post_attn`."""
    R, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :].expand(R, S)
    h = hidden_states(params, config, tokens, positions,
                      lambda li, k, v: (k, v), 0, mlp_fn).float()
    lens = lens.to(dev)
    valid = (torch.arange(S, device=dev)[None, :]
             < lens[:, None]).float()
    pooled = (h * valid[:, :, None]).sum(dim=1) / lens[:, None].float(
        ).clamp(min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)


def prefill(params: dict, config: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, last_only: bool = False, *,
            mlp_fn=None):
    """Right-padded prompts from position 0 through a dense per-request
    cache (causal from position 0 over the bucket; pads sit after each
    prompt, so no real query sees them).

    tokens: [R, S]; prompt_lens: [R]. Returns (logits — [R, 1, V] f32 at
    each row's last prompt position with ``last_only``, else [R, S, V] —
    and the chunk's k/v, each [L, R, S, Hkv, D], for
    ops/paged_kv.write_prefill_batch). ``mlp_fn``: see :func:`_post_attn`."""
    R, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :].expand(R, S)
    shape = (config.num_layers, R, S, config.num_kv_heads, config.head_dim)
    dtype = params["embed"].dtype
    k_all = torch.empty(shape, dtype=dtype, device=dev)
    v_all = torch.empty(shape, dtype=dtype, device=dev)

    def store(li, k, v):
        k_all[li] = k
        v_all[li] = v
        return k, v

    last = ((prompt_lens.to(dev).long() - 1).clamp(min=0) if last_only
            else None)
    logits = _stack(params, config, tokens, positions, store, 0, mlp_fn,
                    last)
    return logits, k_all, v_all


def new_carry(config: ModelConfig, R: int, W: int, dtype: torch.dtype,
              device, prefix_k: Optional[torch.Tensor] = None,
              prefix_v: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A zeroed dense continuation carry (k, v), each [L, R, W, Hkv, D],
    for :func:`prefill_chunk`; a prefix's KV ([L, P, Hkv, D]) is
    broadcast into every row's first P slots (the reference's prefix
    splice, serve/scheduler.py _prefill_first_token_prefix)."""
    shape = (config.num_layers, R, W, config.num_kv_heads, config.head_dim)
    k = torch.zeros(shape, dtype=dtype, device=device)
    v = torch.zeros(shape, dtype=dtype, device=device)
    if prefix_k is not None:
        P = prefix_k.shape[1]
        k[:, :, :P] = prefix_k[:, None]
        v[:, :, :P] = prefix_v[:, None]
    return k, v


def prefill_chunk(params: dict, config: ModelConfig, tokens: torch.Tensor,
                  carry_k: torch.Tensor, carry_v: torch.Tensor, offset: int,
                  last_idx: Optional[torch.Tensor] = None, *,
                  mlp_fn=None) -> torch.Tensor:
    """Continuation prefill: C prompt tokens per row at positions
    ``offset .. offset+C``, resuming from the KV already in the carry
    (:func:`new_carry`, [L, R, W, Hkv, D]) — the chunked-admission unit,
    and with ``offset`` = P over a prefix-seeded carry the prefix-spliced
    suffix forward (the reference's ``prefill_chunk`` and
    ``_prefill_first_token_prefix``).

    Each row writes carry slots ``offset .. offset+C`` IN PLACE and
    attends the carry under ``causal_mask(C, W, offset)``; kernel D never
    reads a slot past the chunk's last position, and a query row's result
    does not depend on how the prompt was cut into chunks.

    ``last_idx`` ([R] int): CHUNK-LOCAL position to gather logits at.
    Returns logits [R, 1, V] f32 (or [R, C, V] without ``last_idx``)."""
    R, C = tokens.shape
    dev = tokens.device
    positions = (offset + torch.arange(C, device=dev))[None, :].expand(R, C)

    def store(li, k, v):
        carry_k[li, :, offset:offset + C] = k
        carry_v[li, :, offset:offset + C] = v
        return carry_k[li], carry_v[li]

    return _stack(params, config, tokens, positions, store, offset, mlp_fn,
                  last_idx)


def decode_step_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, cache: PagedKVCache,
                      active: Optional[torch.Tensor] = None, *,
                      pages: int, mlp_fn=None, impl: Optional[str] = None):
    """One autoregressive step over the paged pool for every row.

    tokens: [B, 1] (this step's input token per row, at position
    ``cache.lengths[b]``). ``impl`` (gather | kernel | flash; None = the
    ``PAGED_ATTN_IMPL`` default of ops/paged_attention) picks the branch,
    as in the reference (llama.py:1089-1109):

    - ``gather``, attend-then-write: each layer attends its pool window
      plus the current token at full precision (kernel B, append mode),
      and ONE write_decode_burst lands every layer's k/v after the loop
      (write-then-attend would read the current token back quantized and
      can flip greedy ties on int8 pools); ``pages`` must cover
      ``lengths``;
    - ``kernel``/``flash``, write-then-attend: each layer writes its k/v
      into the pool (write_decode), then attends ``lengths + 1``
      positions (kernel B, pool mode; bf16 pools only, as the
      reference's ``paged_attention`` refuses an int8 pool there);
      ``pages`` must cover ``lengths + 1``.

    ``active`` ([B] bool) parks rows: their length does not advance and
    their write lands where their (zeroed) table points. ``mlp_fn``: see
    :func:`_post_attn`.

    Returns (logits [B, 1, V] f32, cache) — the cache is updated in
    place, lengths advanced where active."""
    impl = check_impl(pa._DEFAULT_IMPL if impl is None else impl)
    B = tokens.shape[0]
    dev = tokens.device
    layers = params["layers"]
    rope = _rope(config, cache.lengths[:, None])
    h = params["embed"][tokens]
    inc = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32))
    if impl != "gather":
        attend_len = cache.lengths + 1
        for li in range(config.num_layers):
            q, k, v = _attn_qkv(h, layers, li, config, rope)
            write_decode(cache, li, k[:, 0], v[:, 0])
            attn = paged_attention(q[:, 0].contiguous(), cache.k, cache.v,
                                   cache.page_table, attend_len, li,
                                   pages=pages, impl=impl,
                                   k_scale=cache.k_scale,
                                   v_scale=cache.v_scale)
            h = _post_attn(h, attn[:, None], layers, li, config, mlp_fn)
        cache.lengths += inc
        return _logits(params, config, h), cache
    k_steps, v_steps = [], []
    for li in range(config.num_layers):
        q, k, v = _attn_qkv(h, layers, li, config, rope)
        k0, v0 = k[:, 0].contiguous(), v[:, 0].contiguous()
        attn = paged_attention_append(q[:, 0].contiguous(), k0, v0, cache,
                                      cache.lengths, li, pages=pages)
        h = _post_attn(h, attn[:, None], layers, li, config, mlp_fn)
        k_steps.append(k0)
        v_steps.append(v0)
    logits = _logits(params, config, h)
    write_decode_burst(cache, torch.stack(k_steps), torch.stack(v_steps), inc)
    return logits, cache


def decode_fused(params: dict, config: ModelConfig, tokens: torch.Tensor,
                 cache: PagedKVCache, active: Optional[torch.Tensor] = None,
                 *, num_steps: int, sample_fn, sample_state, stop_ids,
                 pages: int, impl: Optional[str] = None, step_fn=None):
    """``num_steps`` autoregressive steps in one call (the reference's
    ``decode_fused``, llama.py:677-744, with a Python loop in place of
    ``lax.scan``), so the serving loop captures K steps in one CUDA graph
    and pays the host one launch for them.

    Each iteration IS the plain step: ``step_fn`` (default
    :func:`decode_step_paged`, either branch by ``impl``) at ``pages``,
    then ``sample_fn(logits [B, V], state, emit_pos [B], active [B]) ->
    (tokens [B], state)`` (the scheduler passes
    models/sampling.sample_step_batched), then the next-token feed — so
    the emitted stream is bitwise the stream of K sequential plain steps.

    **EOS parks inside the loop**: a row whose sampled token is in
    ``stop_ids`` ([n] int64 on the cache's device; empty disables)
    retires there — its length stops advancing, its ring writes drop and
    its feed freezes, the state the host's release would have left
    between two plain steps. ``active`` is a local tensor of the loop and
    is never read back to the host. Later positions of a retired row are
    garbage the caller discards. The caller guarantees every active row
    can absorb ``num_steps`` positions of its KV budget.

    Returns (tokens [K, B], emitted [K, B] bool — whether the row was
    live when that step sampled, next_tokens [B, 1], cache, active [B],
    sample_state). The cache is updated in place."""
    if step_fn is None:
        step_fn = decode_step_paged
    B = tokens.shape[0]
    act = (torch.ones((B,), dtype=torch.bool, device=tokens.device)
           if active is None else active)
    toks_all, emitted = [], []
    for _ in range(num_steps):
        emit_pos = cache.lengths + 1       # emitted token's context slot
        logits, cache = step_fn(params, config, tokens, cache, act,
                                pages=pages, impl=impl)
        toks, sample_state = sample_fn(logits[:, 0, :], sample_state,
                                       emit_pos, act)
        # Parked rows keep their previous input token (the plain step's
        # next-token rule).
        tokens = torch.where(act[:, None], toks[:, None], tokens)
        toks_all.append(toks)
        emitted.append(act)
        if stop_ids.numel():
            act = act & (toks[:, None] != stop_ids[None, :]).all(dim=1)
    return (torch.stack(toks_all), torch.stack(emitted), tokens, cache, act,
            sample_state)


def tree_attention_mask(lengths: torch.Tensor, anc: torch.Tensor,
                        window: int) -> torch.Tensor:
    """Tree-topology attention mask over a contiguous window (the
    reference's ``tree_attention_mask``): lengths [B] committed context
    lengths; anc [B, N, N] bool, anc[b, i, j] iff node j is on node i's
    root path (itself included). Node i sits at slot ``lengths[b] + i``
    and sees every committed slot plus the node slots of its own root
    path. Returns [B, 1, N, W] bool (True = attend)."""
    B, N = anc.shape[:2]
    cols = torch.arange(window, device=anc.device)[None, :]
    lengths = lengths.to(anc.device).long()
    committed = cols < lengths[:, None]                         # [B, W]
    jr = cols - lengths[:, None]
    node_col = (jr >= 0) & (jr < N)
    anc_w = anc.gather(2, jr.clamp(0, N - 1)[:, None, :].expand(B, N,
                                                                window))
    mask = committed[:, None, :] | (node_col[:, None, :] & anc_w)
    return mask[:, None]


def _verify_gather(params: dict, config: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, cache: PagedKVCache, pages: int,
                   mlp_fn, block_mask: Optional[torch.Tensor]):
    """The attend-then-write verify forward: each layer attends the pool
    window plus the block's own k/v under ``block_mask`` (kernel B's
    verify mode on the card), and ONE write_decode_multi_all_layers lands
    every layer's block at ``lengths + i`` after the loop."""
    layers = params["layers"]
    rope = _rope(config, positions)
    h = params["embed"][tokens]
    k_all, v_all = [], []
    for li in range(config.num_layers):
        q, k, v = _attn_qkv(h, layers, li, config, rope)
        k = k.contiguous()
        attn = paged_attention_verify_append(
            q.contiguous(), k, v, cache, cache.lengths, li, pages=pages,
            block_mask=block_mask)
        h = _post_attn(h, attn, layers, li, config, mlp_fn)
        k_all.append(k)
        v_all.append(v)
    logits = _logits(params, config, h)
    write_decode_multi_all_layers(cache, torch.stack(k_all),
                                  torch.stack(v_all))
    return logits, cache


def verify_step_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, cache: PagedKVCache, *,
                      pages: int, mlp_fn=None, impl: Optional[str] = None):
    """Speculative verify over the paged pool (the reference's
    ``verify_step_paged``): S candidate positions per row — tokens [B, S]
    = the pending token then the drafts — at positions ``lengths + j``,
    in one forward. Lengths do not move; the caller accepts a prefix
    (models/sampling.spec_verify_batched) and advances by accepted + 1;
    rejected drafts' slots stay stale past the length.

    ``impl`` picks the branch as :func:`decode_step_paged` does:
    ``gather`` (attend-then-write, int8 or bf16 pools) runs kernel B's
    verify mode per layer with ``pages`` covering ``lengths``;
    ``kernel``/``flash`` (write-then-attend, bf16 pools) writes each
    layer's block (write_decode_multi), then runs kernel B's pool mode
    once per position j over ``lengths + j + 1`` slots, with ``pages``
    covering ``lengths + S``. Returns (logits [B, S, V] f32, cache)."""
    impl = check_impl(pa._DEFAULT_IMPL if impl is None else impl)
    B, S = tokens.shape
    dev = tokens.device
    positions = (cache.lengths[:, None].long()
                 + torch.arange(S, device=dev)[None, :])
    if impl == "gather":
        return _verify_gather(params, config, tokens, positions, cache,
                              pages, mlp_fn, None)
    layers = params["layers"]
    rope = _rope(config, positions)
    h = params["embed"][tokens]
    for li in range(config.num_layers):
        q, k, v = _attn_qkv(h, layers, li, config, rope)
        write_decode_multi(cache, li, k, v)
        attn = torch.stack([paged_attention(
            q[:, j].contiguous(), cache.k, cache.v, cache.page_table,
            cache.lengths + (j + 1), li, pages=pages, impl=impl,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
            for j in range(S)], dim=1)
        h = _post_attn(h, attn, layers, li, config, mlp_fn)
    return _logits(params, config, h), cache


def verify_tree_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, depths: torch.Tensor,
                      anc: torch.Tensor, cache: PagedKVCache, *, pages: int,
                      mlp_fn=None):
    """Tree-speculation verify over the paged pool (the reference's
    ``verify_tree_paged``): N tree nodes per row — tokens [B, N], node 0
    the pending token, nodes 1..K the main chain, the rest sibling leaves
    — scored in one forward. Node i's RoPE position is ``lengths +
    depths[i]`` and its slot ``lengths + i``; it attends the committed
    window plus the nodes of its own root path (``anc`` [B, N, N] bool,
    :func:`tree_attention_mask`'s ancestor matrix). Always the
    attend-then-write branch (kernel B's verify mode under ``anc``),
    whatever the decode impl. Lengths do not move. Returns (logits
    [B, N, V] f32, cache)."""
    positions = cache.lengths[:, None].long() + depths.long()
    return _verify_gather(params, config, tokens, positions, cache, pages,
                          mlp_fn, anc)
