"""llama-family decoder (3.x dense models), the port of
p2p_llm_chat_tpu/models/llama.py for this slice: random int8 init, fused
projections, whole-prompt prefill, and the paged decode step.

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

from ..ops.paged_attention import paged_attention_append
from ..ops.paged_kv import PagedKVCache, write_decode_burst
from ..utils.device import resolve_device
from .configs import ModelConfig
from .layers import (apply_rope_tables, attend_gqa, causal_mask, rms_norm,
                     rope_frequencies, rope_tables)
from .quant import QTensor, mm, quantize


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
    directly. ``quant``: ``int8`` (QTensor leaves) or ``""`` (plain
    ``dtype`` leaves). The distribution is the reference's; the random
    stream is not (torch and jax generators differ)."""
    if quant not in ("int8", ""):
        raise ValueError(f"quant must be int8 or '', got {quant!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, H, E = config.num_layers, config.hidden_size, config.intermediate_size
    std = H ** -0.5

    def normal(shape, scale=std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    dims = {
        "wqkv": (H, config.q_dim + 2 * config.kv_dim),
        "wo": (config.q_dim, H),
        "wgu": (H, 2 * E),
        "w_down": (E, H),
    }
    layers: dict = {
        "attn_norm": torch.ones((L, H), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, H), dtype=dtype, device=device),
    }
    for name, (din, dout) in dims.items():
        if quant:
            layers[name] = QTensor(
                q=torch.empty((L, din, dout), dtype=torch.int8,
                              device=device),
                s=torch.empty((L, 1, dout), dtype=torch.float32,
                              device=device))
        else:
            layers[name] = torch.empty((L, din, dout), dtype=dtype,
                                       device=device)
    for li in range(L):
        for name, (din, dout) in dims.items():
            w = normal((din, dout))
            if quant:
                qt = quantize(w)
                layers[name].q[li] = qt.q
                layers[name].s[li] = qt.s
            else:
                layers[name][li] = w
            del w
    params = {
        "embed": normal((config.vocab_size, H), scale=1.0),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=dtype, device=device),
    }
    if not config.tie_embeddings:
        head = normal((H, config.vocab_size))
        params["lm_head"] = quantize(head) if quant else head
    return params


def fuse_params(params: dict) -> dict:
    """Concatenate per-layer ``wq|wk|wv -> wqkv`` and ``w_gate|w_up ->
    wgu`` on the output axis (int8 scales ride their columns). No-op on
    an already fused tree."""
    layers = params["layers"]
    if "wqkv" in layers:
        return params

    def cat(ws):
        if isinstance(ws[0], QTensor):
            return QTensor(q=torch.cat([w.q for w in ws], dim=-1),
                           s=torch.cat([w.s for w in ws], dim=-1))
        return torch.cat(ws, dim=-1)

    fused = {k: v for k, v in layers.items()
             if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
    fused["wqkv"] = cat([layers["wq"], layers["wk"], layers["wv"]])
    fused["wgu"] = cat([layers["w_gate"], layers["w_up"]])
    out = dict(params)
    out["layers"] = fused
    return out


@functools.lru_cache(maxsize=16)
def _inv_freq(config: ModelConfig, device: str) -> torch.Tensor:
    return rope_frequencies(config, device)


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
               config: ModelConfig) -> torch.Tensor:
    """Output projection + residual + SwiGLU MLP + residual."""
    B, S = attn.shape[:2]
    h = h + mm(attn.reshape(B, S, config.q_dim), layers["wo"], li)
    x = rms_norm(h, layers["mlp_norm"][li], config.rms_norm_eps)
    gu = mm(x, layers["wgu"], li)
    E = gu.shape[-1] // 2
    g = torch.nn.functional.silu(gu[..., :E]) * gu[..., E:]
    return h + mm(g, layers["w_down"], li)


def _logits(params: dict, config: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], config.rms_norm_eps)
    lm_head = (params["embed"].T if config.tie_embeddings
               else params["lm_head"])
    return mm(h, lm_head).float()


def prefill(params: dict, config: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, last_only: bool = False):
    """Right-padded prompts from position 0 through a dense per-request
    cache (causal mask over the bucket; pads sit after each prompt).

    tokens: [R, S]; prompt_lens: [R]. Returns (logits — [R, 1, V] f32 at
    each row's last prompt position with ``last_only``, else [R, S, V] —
    and the chunk's k/v, each [L, R, S, Hkv, D], for
    ops/paged_kv.write_prefill_batch)."""
    R, S = tokens.shape
    dev = tokens.device
    layers = params["layers"]
    positions = torch.arange(S, device=dev)[None, :].expand(R, S)
    mask = causal_mask(S, S, 0, dev)
    rope = _rope(config, positions)
    h = params["embed"][tokens]
    shape = (config.num_layers, R, S, config.num_kv_heads, config.head_dim)
    k_all = torch.empty(shape, dtype=h.dtype, device=dev)
    v_all = torch.empty(shape, dtype=h.dtype, device=dev)
    for li in range(config.num_layers):
        q, k, v = _attn_qkv(h, layers, li, config, rope)
        k_all[li] = k
        v_all[li] = v
        h = _post_attn(h, attend_gqa(q, k, v, mask), layers, li, config)
    if last_only:
        idx = (prompt_lens.to(dev).long() - 1).clamp(min=0)
        h = h[torch.arange(R, device=dev), idx][:, None]
    return _logits(params, config, h), k_all, v_all


def decode_step_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, cache: PagedKVCache,
                      active: Optional[torch.Tensor] = None, *,
                      pages: int):
    """One autoregressive step over the paged pool for every row.

    tokens: [B, 1] (this step's input token per row, at position
    ``cache.lengths[b]``). Attend-then-write: each layer attends its pool
    window plus the current token at full precision (kernel B), and ONE
    write_decode_burst lands every layer's k/v after the loop — the
    reference's ordering (write-then-attend would read the current token
    back quantized and can flip greedy ties on int8 pools). ``active``
    ([B] bool) parks rows: their length does not advance and their write
    lands where their (zeroed) table points. ``pages`` page-table entries
    per row are walked (ceil(max live length / page_size)).

    Returns (logits [B, 1, V] f32, cache) — the cache is updated in
    place, lengths advanced where active."""
    B = tokens.shape[0]
    dev = tokens.device
    layers = params["layers"]
    rope = _rope(config, cache.lengths[:, None])
    h = params["embed"][tokens]
    k_steps, v_steps = [], []
    for li in range(config.num_layers):
        q, k, v = _attn_qkv(h, layers, li, config, rope)
        k0, v0 = k[:, 0].contiguous(), v[:, 0].contiguous()
        attn = paged_attention_append(q[:, 0].contiguous(), k0, v0, cache,
                                      cache.lengths, li, pages=pages)
        h = _post_attn(h, attn[:, None], layers, li, config)
        k_steps.append(k0)
        v_steps.append(v0)
    logits = _logits(params, config, h)
    inc = (torch.ones(B, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32))
    write_decode_burst(cache, torch.stack(k_steps), torch.stack(v_steps), inc)
    return logits, cache
