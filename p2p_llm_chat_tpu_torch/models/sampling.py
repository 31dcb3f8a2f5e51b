"""Token sampling: greedy, temperature, top-k, top-p, repeat penalty —
the port of the batched samplers of p2p_llm_chat_tpu/models/sampling.py.

Per-row options and per-row keys live on the device, as the reference's
do, so a decode step samples without a host sync (a CUDA graph captures
it whole). A key is ``[seed, counter]`` (int64): the row's uniform is a
hash of the pair, written in torch integer ops, and every call advances
the counter of every row, live or parked, as the reference splits every
row's PRNG key. A row's draw therefore depends on its own key alone —
not on the batch, on how many steps one dispatch fuses, or on the
pipeline — which is what makes fused and plain streams identical.

The hash is not threefry, so sampled rows cannot match the reference's
tokens: greedy output is compared token for token and sampled output as
the warped distribution (:func:`_warp`) fed the same logits.
"""

from __future__ import annotations

from typing import Optional

import torch

from .layers import NEG_INF

_M32 = 0xFFFFFFFF
# Odd multipliers below 2^31: a product of one with a 32-bit value stays
# below 2^63, so int64 arithmetic never wraps (torch has no full uint32
# arithmetic on CUDA).
_MUL1 = 0x7FEB352D
_MUL2 = 0x5BD1E995
_GOLDEN = 0x1E3779B9


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def apply_repeat_penalty(logits: torch.Tensor, ring: torch.Tensor,
                         rp: torch.Tensor) -> torch.Tensor:
    """Ollama-style repetition penalty over a recent-token ring.

    logits: [B,V]; ring: [B,R] recent ids (entries >= V are empty slots);
    rp: [B] penalty (1.0 = identity). Tokens in the ring have positive
    logits divided by rp and negative logits multiplied by it. Runs before
    top-k/top-p: the penalty reorders candidates."""
    B, V = logits.shape
    mask = torch.zeros((B, V + 1), dtype=torch.bool, device=logits.device)
    mask.scatter_(1, ring.long().clamp(max=V), True)
    mask = mask[:, :V]
    rp = rp[:, None].to(logits.dtype)
    pen = torch.where(logits > 0, logits / rp, logits * rp)
    return torch.where(mask, pen, logits)


def _warp(sorted_logits: torch.Tensor, temperature: torch.Tensor,
          top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row warping over a descending top-c candidate axis:
    temperature, then top-k, then top-p on the renormalised distribution.
    sorted_logits [B, C]; temperature/top_k/top_p [B]. Returns warped
    probabilities [B, C] (the reference's ``_warp``). The kept candidates
    are a prefix of the axis."""
    C = sorted_logits.shape[-1]
    ranks = torch.arange(C, device=sorted_logits.device)[None, :]
    tk = top_k[:, None]
    keep_k = (tk <= 0) | (ranks < tk)
    temp = temperature.clamp(min=1e-6)[:, None].to(sorted_logits.dtype)
    scaled = sorted_logits / temp
    probs = torch.softmax(torch.where(keep_k, scaled, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p[:, None].to(probs.dtype)
    keep_p = (tp >= 1.0) | ((cum - probs) < tp)
    # Never empty (rank 0 always kept). An index write of a Python bool
    # would copy it from the host, which a CUDA graph cannot capture.
    keep = (keep_k & keep_p) | (ranks == 0)
    return torch.softmax(torch.where(keep, scaled, NEG_INF), dim=-1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (xor-shift, multiply) over int64 values in
    [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def uniforms(keys: torch.Tensor) -> torch.Tensor:
    """One f32 uniform in [0, 1) per key ([B, 2] int64 ``[seed,
    counter]``): 24 bits of a hash of the pair, exact in f32."""
    seed = keys[:, 0] & _M32
    ctr = keys[:, 1] & _M32
    h = _mix32(seed ^ _mix32((ctr + _GOLDEN) & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def advance(keys: torch.Tensor) -> torch.Tensor:
    """Every row's key one step on: the counter plus one."""
    return torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1)


def sample_batched(logits: torch.Tensor, keys: torch.Tensor,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor, top_c: int = 64,
                   ring: Optional[torch.Tensor] = None,
                   rp: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row sampling: logits [B,V] f32; keys [B,2] int64;
    temperature/top_k/top_p [B]. temperature <= 0 is greedy (argmax of
    the penalised logits); top_k <= 0 and top_p >= 1 disable those
    filters. Candidates are truncated to the ``top_c`` highest logits, as
    in the reference; a sampled row takes the candidate at its uniform by
    inverse CDF over the warped probabilities, clamped to the last
    candidate of nonzero probability. Returns (tokens [B] int64, advanced
    keys [B,2]). No host sync."""
    B, V = logits.shape
    if ring is not None:
        logits = apply_repeat_penalty(logits, ring, rp)
    C = min(top_c, V)
    sorted_logits, order = torch.topk(logits, C, dim=-1)
    wprobs = _warp(sorted_logits, temperature, top_k, top_p)
    cdf = torch.cumsum(wprobs, dim=-1)
    u = uniforms(keys)[:, None]
    # Positive probabilities are a prefix (kept candidates are, and
    # sorted logits do not rise), so their count - 1 is the last of them.
    last = (wprobs > 0).sum(dim=-1, keepdim=True) - 1
    choice = torch.minimum(torch.searchsorted(cdf, u, right=True), last)
    sampled = order.gather(1, choice)[:, 0]
    tok = torch.where(temperature > 0, sampled, logits.argmax(dim=-1))
    return tok, advance(keys)


def sample_step_batched(logits: torch.Tensor, keys: torch.Tensor,
                        temperature: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor, *, ring: torch.Tensor,
                        rp: torch.Tensor, emit_pos: torch.Tensor,
                        active: torch.Tensor, top_c: int = 64
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode tick's sample + penalty-ring update (the reference's
    ``sample_step_batched``, the one implementation the plain tick and
    each step of models/llama.decode_fused run): the emitted token joins
    row b's ring at ``emit_pos[b] % R`` where ``active``; parked rows'
    rings are untouched, but their keys advance. Returns (tokens [B],
    advanced keys [B, 2], ring [B, R])."""
    toks, keys = sample_batched(logits, keys, temperature, top_k, top_p,
                                top_c=top_c, ring=ring, rp=rp)
    B, R = ring.shape
    idx = torch.where(active, emit_pos.long() % R,
                      torch.full_like(emit_pos.long(), R))
    ext = torch.cat([ring, ring.new_zeros((B, 1))], dim=1)
    ext.scatter_(1, idx[:, None], toks[:, None].to(ring.dtype))
    return toks, keys, ext[:, :R]
