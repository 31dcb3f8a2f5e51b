"""Transformer layer primitives, the port of p2p_llm_chat_tpu/models/layers.py.

Same conventions as the reference: activations in the params' dtype (bf16
in serving), normalisation statistics and attention softmax in f32,
weights stored ``[in, out]`` so matmuls are ``x @ w``, and the dense cache
layout ``[batch, seq, kv_heads, head_dim]``. Prefill attention
(:func:`attend_gqa_auto`) runs kernel D on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .configs import ModelConfig

# A large-negative constant for masking that is safe in bf16/f32 softmax.
NEG_INF = -1e9


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, result cast back to x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def rope_frequencies(config: ModelConfig,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies [head_dim/2] in f32, with llama3.1 NTK-by-parts
    scaling applied when configured."""
    d = config.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv_freq = 1.0 / (torch.tensor(config.rope_theta, dtype=torch.float32,
                                   device=device) ** exps)
    s = config.rope_scaling
    if s is None:
        return inv_freq
    low_wavelen = s.original_max_position / s.low_freq_factor
    high_wavelen = s.original_max_position / s.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / s.factor
    smooth = (s.original_max_position / wavelen - s.low_freq_factor) / (
        s.high_freq_factor - s.low_freq_factor)
    smooth = smooth.clamp(0.0, 1.0)
    blended = (1.0 - smooth) * scaled + smooth * inv_freq
    return torch.where(wavelen > low_wavelen, scaled,
                       torch.where(wavelen < high_wavelen, inv_freq, blended))


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of position*freq, each [..., S, 1, d/2] f32, for
    :func:`apply_rope_tables` (one pair serves every layer of a step)."""
    angles = positions[..., :, None].float() * inv_freq     # [..., S, d/2]
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by position*freq (HF
    llama's rotate_half convention). x: [..., S, H, D]; positions
    [..., S]."""
    return apply_rope_tables(x, *rope_tables(positions, inv_freq))


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """:func:`apply_rope` with the tables of :func:`rope_tables`."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand kv heads to query heads. [B,S,Hkv,D] -> [B,S,Hkv*n,D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attend_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Grouped-query attention without materialising repeated kv heads.

    q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D]; mask broadcastable to
    [B,1,Sq,Skv] (True = attend). Scores and softmax in f32; the
    probabilities are cast to v's dtype for the p.v product, as in the
    reference. Query head h maps to kv head h // rep."""
    B, Sq, Hq, D = q.shape
    G = k.shape[2]
    rep = Hq // G
    qg = q.reshape(B, Sq, G, rep, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        if mask.ndim == 4:                     # [B|1, 1, Sq, Skv]
            mask = mask[:, :, None]            # -> [B|1, 1, 1, Sq, Skv]
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)


def gqa_lse(q: torch.Tensor, k: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The log-sum-exp (natural log, f32) of each query row's scaled
    scores under ``mask`` (as :func:`attend_gqa` takes them): [B, Hq, Sq].
    A row that sees nothing is -inf (masked scores are -inf here, not
    ``NEG_INF``). These are the softmax statistics that merge partial
    attentions over disjoint key sets (the reference's ``_online_update``
    (m, l) as ``m + log l``)."""
    B, Sq, Hq, D = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, Hq // G, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    if mask is not None:
        if mask.ndim == 4:                     # [B|1, 1, Sq, Skv]
            mask = mask[:, :, None]
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(scores, dim=-1).reshape(B, Hq, Sq)


def attend_gqa_causal0(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Causal-from-position-0 attention over equal-length q/k/v
    ([B, S, H*, D]): the whole-prompt prefill's shape, kernel D on the
    card (ops/prefill_attention.py)."""
    return attend_gqa_auto(q, k, v, 0)


def attend_gqa_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0) -> torch.Tensor:
    """Prefill attention under ``causal_mask(Sq, Skv, q_offset)``: query i
    at absolute position ``q_offset + i`` sees kv positions
    ``j <= q_offset + i``. q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D].

    The reference's namesake picks by size (a dense XLA attend, an XLA
    flash scan past ``_FLASH_SCORE_ELEMS``, the Pallas flash kernel for
    causal-from-0 shapes with ``S % 512 == 0``); on the card kernel D
    serves every size and offset, and on the CPU the plain
    :func:`attend_gqa` runs (ops/prefill_attention.py)."""
    from ..ops.prefill_attention import prefill_attention
    return prefill_attention(q, k, v, q_offset)


def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """[1,1,Sq,Skv] boolean mask: query i (at absolute pos q_offset+i) may
    attend kv position j iff j <= q_offset+i."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return (kv_pos <= q_pos)[None, None, :, :]


def length_mask(kv_len: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B,1,1,Skv] mask limiting attention to the first ``lengths[b]``
    cache slots."""
    kv_pos = torch.arange(kv_len, device=lengths.device)[None, :]
    return (kv_pos < lengths[:, None])[:, None, None, :]
