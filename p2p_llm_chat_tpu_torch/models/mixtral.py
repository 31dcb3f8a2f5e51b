"""Mixtral-family sparse-MoE decoder, the port of
p2p_llm_chat_tpu/models/mixtral.py for the paged serving path.

The attention, cache and layer-loop mechanics are llama's: :func:`prefill`,
:func:`prefill_chunk` and :func:`decode_step_paged` pass the sparse-MoE
MLP into models/llama.py through its ``mlp_fn`` hook (and
:func:`decode_fused` runs llama's loop over this module's step), so only
the expert MLP lives here.

- **Scatter/gather dispatch** with static capacity buckets: each token's
  top-k expert assignments are scattered into an ``[NE*C, H]`` bucket
  array, the expert FFNs run as one batched ``[NE, C, H] x [NE, H, F]``
  product (kernel A or C over the expert axis at <= 512 rows per bucket,
  models/quant.q_einsum), and outputs gather back with renormalised
  router weights.
- **Capacity**: ``capacity=None`` is exact/dropless (C = T; decode's
  default). Prefill bounds C at ``moe_capacity_factor * T * k / NE`` of
  the padded bucket's T tokens; an overflowing token loses only its MLP
  contribution (the residual carries it).
- Router math in float32 (softmax over all experts, top-k with ties to
  the lower expert index, renormalised), as the reference and HF's
  MixtralSparseMoeBlock do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import llama
from .configs import ModelConfig
from .llama import fuse_params, new_carry  # noqa: F401  (llama's layout)
from .quant import q_einsum

# Sentinel: "derive capacity from config.moe_capacity_factor".
_AUTO = "auto"


def init_params_quantized(config: ModelConfig, seed: int = 0,
                          dtype: torch.dtype = torch.bfloat16,
                          quant: str = "int8",
                          device: Optional[torch.device | str] = None
                          ) -> dict:
    """Random init straight into the FUSED tree, layer by layer (and one
    expert at a time) on ``device`` (the card unless the CPU is asked for;
    see utils/device.py): ``wqkv``, ``wo``, the per-expert ``wgu_e``
    [NE, H, 2F] and ``w_down`` [NE, F, H] at ``quant`` (``int8``, ``int4``
    or ``""``), the router bf16. ``fuse_params`` is a no-op on the
    result. mixtral-8x7b is ~46.8 GB at int8 and ~24.8 GB at int4."""
    if not config.is_moe:
        raise ValueError("mixtral.init_params_quantized needs experts")
    H, NE = config.hidden_size, config.num_experts
    F_ = config.intermediate_size
    dims = {
        "wqkv": (H, config.q_dim + 2 * config.kv_dim),
        "wo": (config.q_dim, H),
        "wgu_e": (NE, H, 2 * F_),
        "w_down": (NE, F_, H),
    }
    return llama.random_tree(config, dims, {"router": (H, NE)}, seed, dtype,
                             quant, device)


def _top_k(probs: torch.Tensor, k: int):
    """Top ``k`` along the last axis with ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` leaves tie order unspecified)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    top_i = idx[..., :k]
    return probs.gather(-1, top_i), top_i


def moe_mlp(x: torch.Tensor, router: torch.Tensor, w_gate, w_up, w_down,
            num_experts_per_tok: int, capacity: Optional[int] = None,
            w_gu=None, layer: Optional[int] = None) -> torch.Tensor:
    """Sparse-MoE SwiGLU via scatter/gather dispatch into capacity buckets.

    x: [B,S,H]; router: [H,NE]; w_gate/w_up: [NE,H,F]; w_down: [NE,F,H]
    (each ``[L, ...]``-stacked and read at ``layer`` when it is given).
    ``w_gu`` ([NE,H,2F], gate|up concatenated): when given, gate and up
    run as one batched product and w_gate/w_up are ignored. ``capacity``
    is the per-expert bucket size C (None = T = exact).

    The bucket array carries one extra row at index NE*C: an overflowing
    selection is written there and discarded, and reads 0 back — the
    reference's scatter ``mode="drop"`` and gather ``mode="fill"``."""
    B, S, H = x.shape
    if layer is not None:
        router = router[layer]
    NE = router.shape[-1]
    k = num_experts_per_tok
    T = B * S
    C = T if capacity is None else max(1, min(capacity, T))
    xt = x.reshape(T, H)

    logits = xt.float() @ router.float()                         # [T,NE]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)                              # [T,k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # Position-in-expert with (token, selection-slot) priority: cumsum of
    # the selection one-hot over the t-major flattened [T*k] selections.
    expert = top_i.reshape(T * k)
    flat = F.one_hot(expert, NE)                                 # [T*k,NE]
    pos = torch.cumsum(flat, dim=0) - flat
    slot = (flat * pos).sum(dim=-1)                              # [T*k]
    idx = torch.where(slot < C, expert * C + slot,
                      torch.full_like(slot, NE * C))

    xin = torch.zeros((NE * C + 1, H), dtype=x.dtype, device=x.device)
    xin[idx] = xt.repeat_interleave(k, dim=0)
    xin = xin[:NE * C].reshape(NE, C, H)
    if w_gu is not None:
        gu = q_einsum("ech,ehf->ecf", xin, w_gu, layer)          # [NE,C,2F]
        Fh = gu.shape[-1] // 2
        g, u = F.silu(gu[..., :Fh]), gu[..., Fh:]
    else:
        g = F.silu(q_einsum("ech,ehf->ecf", xin, w_gate, layer))
        u = q_einsum("ech,ehf->ecf", xin, w_up, layer)
    y = q_einsum("ecf,efh->ech", g * u, w_down, layer)           # [NE,C,H]

    y = torch.cat([y.reshape(NE * C, H),
                   torch.zeros((1, H), dtype=y.dtype, device=y.device)])
    gathered = y[idx]                                            # [T*k,H]
    out = (gathered.reshape(T, k, H).float() * top_w[..., None]).sum(dim=1)
    return out.to(x.dtype).reshape(B, S, H)


def _capacity_for(config: ModelConfig, tokens: int,
                  capacity) -> Optional[int]:
    """Resolve the capacity argument: _AUTO -> config.moe_capacity_factor
    (None factor = exact/dropless)."""
    if capacity is not _AUTO:
        return capacity
    f = config.moe_capacity_factor
    if f is None:
        return None
    return max(1, int(f * tokens * config.num_experts_per_tok
                      / config.num_experts))


def _mlp_fn(config: ModelConfig, capacity: Optional[int]):
    def fn(x: torch.Tensor, layers: dict, li: int) -> torch.Tensor:
        return moe_mlp(x, layers["router"], layers.get("w_gate"),
                       layers.get("w_up"), layers["w_down"],
                       config.num_experts_per_tok, capacity,
                       w_gu=layers.get("wgu_e"), layer=li)
    return fn


def prefill(params: dict, config: ModelConfig, tokens: torch.Tensor,
            prompt_lens: torch.Tensor, last_only: bool = False,
            capacity=_AUTO):
    """llama.prefill with the MoE MLP (same contract). The capacity is
    reckoned from the padded bucket's R*S tokens, as the reference's."""
    cap = _capacity_for(config, int(tokens.shape[0] * tokens.shape[1]),
                        capacity)
    return llama.prefill(params, config, tokens, prompt_lens, last_only,
                         mlp_fn=_mlp_fn(config, cap))


def prefill_chunk(params: dict, config: ModelConfig, tokens: torch.Tensor,
                  carry_k: torch.Tensor, carry_v: torch.Tensor, offset: int,
                  last_idx: Optional[torch.Tensor] = None,
                  capacity=_AUTO) -> torch.Tensor:
    """llama.prefill_chunk with the MoE MLP (same contract). The capacity
    is reckoned from the CHUNK's R*C tokens, as the reference's, so under
    a bounding ``moe_capacity_factor`` (mixtral-8x7b prefills at 2.0) an
    expert bucket can overflow differently than in the whole-prompt
    bucket: chunked prefill is exact only while no bucket overflows (the
    dropless configs, capacity None, are exact)."""
    cap = _capacity_for(config, int(tokens.shape[0] * tokens.shape[1]),
                        capacity)
    return llama.prefill_chunk(params, config, tokens, carry_k, carry_v,
                               offset, last_idx, mlp_fn=_mlp_fn(config, cap))


def embed_pooled(params: dict, config: ModelConfig, tokens: torch.Tensor,
                 lens: torch.Tensor, capacity=_AUTO) -> torch.Tensor:
    """llama.embed_pooled with the MoE MLP (the /api/embed backend; same
    contract). The capacity is reckoned from the padded bucket's R*S
    tokens, as the reference's (mixtral.py:442-451), so pad positions use
    up expert capacity exactly as they do there."""
    cap = _capacity_for(config, int(tokens.shape[0] * tokens.shape[1]),
                        capacity)
    return llama.embed_pooled(params, config, tokens, lens,
                              mlp_fn=_mlp_fn(config, cap))


def decode_step_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, cache, active=None, *,
                      pages: int, impl: Optional[str] = None):
    """llama.decode_step_paged with the MoE MLP (same contract, both
    branches: the attention impl rides along below the ``mlp_fn`` seam,
    as in the reference's mixtral.py:403-417). Decode is always dropless:
    C = the batch."""
    return llama.decode_step_paged(params, config, tokens, cache, active,
                                   pages=pages, mlp_fn=_mlp_fn(config, None),
                                   impl=impl)


def decode_fused(params: dict, config: ModelConfig, tokens: torch.Tensor,
                 cache, active=None, *, num_steps: int, sample_fn,
                 sample_state, stop_ids, pages: int,
                 impl: Optional[str] = None):
    """llama.decode_fused over the MoE step (the reference's
    mixtral.py:355-372; same contract: K steps in one call, EOS parks
    inside the loop, bitwise K sequential plain steps). Decode is
    dropless: C = the batch."""
    return llama.decode_fused(params, config, tokens, cache, active,
                              num_steps=num_steps, sample_fn=sample_fn,
                              sample_state=sample_state, stop_ids=stop_ids,
                              pages=pages, impl=impl,
                              step_fn=decode_step_paged)


def verify_step_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, cache, *, pages: int,
                      impl: Optional[str] = None):
    """llama.verify_step_paged with the MoE MLP (the reference's
    mixtral.py:420-429): the expert grid sees the verify's B*S tokens,
    dropless (capacity None)."""
    return llama.verify_step_paged(params, config, tokens, cache,
                                   pages=pages, mlp_fn=_mlp_fn(config, None),
                                   impl=impl)


def verify_tree_paged(params: dict, config: ModelConfig,
                      tokens: torch.Tensor, depths: torch.Tensor,
                      anc: torch.Tensor, cache, *, pages: int):
    """llama.verify_tree_paged with the MoE MLP, dropless (the
    reference's mixtral.py:432-439)."""
    return llama.verify_tree_paged(params, config, tokens, depths, anc,
                                   cache, pages=pages,
                                   mlp_fn=_mlp_fn(config, None))
