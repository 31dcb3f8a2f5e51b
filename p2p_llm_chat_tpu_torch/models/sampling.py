"""Token sampling: greedy, temperature, top-k, top-p, repeat penalty —
the port of the batched samplers of p2p_llm_chat_tpu/models/sampling.py.

Per-row options and per-row ``torch.Generator``s (seeded from the
request's ``options.seed``) replace the reference's per-row PRNG keys.
The two frameworks draw different numbers from the same seed, so greedy
output is compared token for token and sampled output as the warped
distribution (:func:`_warp`) fed the same logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .layers import NEG_INF


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
    probabilities [B, C] (the reference's ``_warp``)."""
    C = sorted_logits.shape[-1]
    ranks = torch.arange(C, device=sorted_logits.device)[None, :]
    tk = top_k[:, None]
    keep_k = (tk <= 0) | (ranks < tk)
    temp = temperature.clamp(min=1e-6)[:, None].to(sorted_logits.dtype)
    neg = torch.tensor(NEG_INF, dtype=sorted_logits.dtype,
                       device=sorted_logits.device)
    scaled = sorted_logits / temp
    probs = torch.softmax(torch.where(keep_k, scaled, neg), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p[:, None].to(probs.dtype)
    keep_p = (tp >= 1.0) | ((cum - probs) < tp)
    keep = keep_k & keep_p
    keep[:, 0] = True                                  # never empty
    return torch.softmax(torch.where(keep, scaled, neg), dim=-1)


def sample_batched(logits: torch.Tensor,
                   generators: Sequence[Optional[torch.Generator]],
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor, top_c: int = 64,
                   ring: Optional[torch.Tensor] = None,
                   rp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sampling: logits [B,V] f32; one generator per row;
    temperature/top_k/top_p [B]. temperature <= 0 is greedy (argmax of
    the penalised logits); top_k <= 0 and top_p >= 1 disable those
    filters. Candidates are truncated to the ``top_c`` highest logits, as
    in the reference. Returns tokens [B] (int64)."""
    B, V = logits.shape
    if ring is not None:
        logits = apply_repeat_penalty(logits, ring, rp)
    tok = logits.argmax(dim=-1)
    sampled = [b for b, t in enumerate(temperature.tolist()) if t > 0.0]
    if not sampled:
        return tok
    C = min(top_c, V)
    sorted_logits, order = torch.topk(logits, C, dim=-1)
    wprobs = _warp(sorted_logits, temperature.to(logits.device),
                   top_k.to(logits.device), top_p.to(logits.device))
    for b in sampled:
        choice = torch.multinomial(wprobs[b], 1, generator=generators[b])
        tok[b] = order[b, choice[0]]
    return tok


def sample_step_batched(logits: torch.Tensor,
                        generators: Sequence[Optional[torch.Generator]],
                        temperature: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor, *, ring: torch.Tensor,
                        rp: torch.Tensor, emit_pos: torch.Tensor,
                        active: torch.Tensor, top_c: int = 64
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode tick's sample + penalty-ring update: the emitted token
    joins row b's ring at ``emit_pos[b] % R`` where ``active``; parked
    rows' rings are untouched. Returns (tokens [B], ring [B, R])."""
    toks = sample_batched(logits, generators, temperature, top_k, top_p,
                          top_c=top_c, ring=ring, rp=rp)
    B, R = ring.shape
    idx = torch.where(active, emit_pos.long() % R,
                      torch.full_like(emit_pos.long(), R))
    ext = torch.cat([ring, ring.new_zeros((B, 1))], dim=1)
    ext.scatter_(1, idx[:, None], toks[:, None].to(ring.dtype))
    return toks, ext[:, :R]
