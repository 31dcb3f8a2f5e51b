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
    sorted_logits [B, ..., C]; temperature/top_k/top_p [B], broadcast over
    any middle axes. Returns warped probabilities of sorted_logits' shape
    (the reference's ``_warp``: the decode tick and speculative acceptance
    warp alike, or speculation stops matching sequential sampling). The
    kept candidates are a prefix of the axis."""
    C = sorted_logits.shape[-1]
    shape = (sorted_logits.shape[0],) + (1,) * (sorted_logits.ndim - 1)
    ranks = torch.arange(C, device=sorted_logits.device)
    tk = top_k.reshape(shape)
    keep_k = (tk <= 0) | (ranks < tk)
    temp = temperature.clamp(min=1e-6).reshape(shape).to(
        sorted_logits.dtype)
    scaled = sorted_logits / temp
    probs = torch.softmax(torch.where(keep_k, scaled, NEG_INF), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p.reshape(shape).to(probs.dtype)
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


def _hash_uniform(seed: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """Elementwise f32 uniforms in [0, 1) of int64 ``(seed, counter)``
    pairs (any broadcastable shapes): 24 bits of a hash of the pair,
    exact in f32."""
    seed = seed & _M32
    ctr = ctr & _M32
    h = _mix32(seed ^ _mix32((ctr + _GOLDEN) & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniforms(keys: torch.Tensor) -> torch.Tensor:
    """One f32 uniform in [0, 1) per key ([B, 2] int64 ``[seed,
    counter]``)."""
    return _hash_uniform(keys[:, 0], keys[:, 1])


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


def _draw(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of the candidate at uniform ``u`` [B] by inverse CDF over
    ``probs`` [B, C] (normalised; zeros anywhere are never drawn),
    clamped to the last candidate of nonzero probability."""
    cdf = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(probs.shape[-1], device=probs.device)
    last = torch.where(probs > 0, ranks, 0).amax(dim=-1, keepdim=True)
    return torch.minimum(
        torch.searchsorted(cdf, u[:, None].contiguous(), right=True),
        last)[:, 0]


def _column(ids: torch.Tensor, V: int) -> torch.Tensor:
    """ids as columns of a [..., V + 1] count: ids outside [0, V) (empty
    ring slots, absent siblings) go to the dropped column V, as a
    one-hot of them is all zero in the reference."""
    ids = ids.long()
    return torch.where((ids < 0) | (ids >= V), V, ids)


def _counts(ids: torch.Tensor, V: int) -> torch.Tensor:
    """Occurrence counts [..., V] f32 of ids [..., n] over the last axis
    (ids outside [0, V) drop out). No host sync (no one_hot)."""
    out = torch.zeros((*ids.shape[:-1], V + 1), dtype=torch.float32,
                      device=ids.device)
    out.scatter_add_(-1, _column(ids, V),
                     torch.ones(ids.shape, dtype=torch.float32,
                                device=ids.device))
    return out[..., :V]


def _prefix_counts(ids: torch.Tensor, V: int) -> torch.Tensor:
    """[B, n+1, V]: entry i counts ids[:, :i] (ids outside [0, V)
    drop)."""
    B, n = ids.shape
    one = torch.zeros((B, n, V + 1), dtype=torch.float32, device=ids.device)
    one.scatter_(-1, _column(ids, V)[..., None], 1.0)
    zero = torch.zeros((B, 1, V), dtype=torch.float32, device=ids.device)
    return torch.cat([zero, torch.cumsum(one[..., :V], dim=1)], dim=1)


def _penalise(logits: torch.Tensor, cnt: torch.Tensor,
              rp: torch.Tensor) -> torch.Tensor:
    """Repeat penalty where ``cnt`` > 0.5 (logits [B, ..., V])."""
    rp_b = rp.reshape((rp.shape[0],) + (1,) * (logits.ndim - 1)).to(
        logits.dtype)
    pen = torch.where(logits > 0, logits / rp_b, logits * rp_b)
    return torch.where(cnt > 0.5, pen, logits)


def _chain_penalty(logits, drafts, ring, rp, ctx_len):
    """The sliding-window penalty of a speculative chain (the reference's
    algebra): position j of logits [B, K+1, V] penalises the last R
    tokens of context + drafts[:j] — each draft enters the window and
    evicts the ring slot ``(ctx_len + i) % R``. Returns (penalised
    logits, in_cnt [B, V], ev_pref, dr_pref [B, K+1, V])."""
    B, S, V = logits.shape
    K = S - 1
    R = ring.shape[1]
    in_cnt = _counts(ring, V)
    shifts = torch.arange(1, K + 1, device=ring.device)[None, :]
    ev_slots = (ctx_len.long()[:, None] + shifts) % R
    ev = ring.gather(1, ev_slots)
    ev_pref = _prefix_counts(ev, V)
    dr_pref = _prefix_counts(drafts, V)
    cnt = in_cnt[:, None] - ev_pref + dr_pref
    return _penalise(logits, cnt, rp), in_cnt, ev_pref, dr_pref


def _top_warp(logits, temperature, top_k, top_p, top_c):
    """(sorted candidates' order, warped probabilities) of logits
    [B, S, V] over the top ``top_c``."""
    B, S, V = logits.shape
    C = min(top_c, V)
    sorted_logits, order = torch.topk(logits.reshape(B * S, V), C, dim=-1)
    return (order.reshape(B, S, C),
            _warp(sorted_logits.reshape(B, S, C), temperature, top_k, top_p))


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] over axis 1 (x [B, S, ...]; idx [B])."""
    ix = idx.long().reshape(-1, 1, *([1] * (x.ndim - 2)))
    return x.gather(1, ix.expand(-1, 1, *x.shape[2:]))[:, 0]


def spec_verify_batched(logits: torch.Tensor, drafts: torch.Tensor,
                        keys: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        max_accept: torch.Tensor, top_c: int = 64,
                        ring: Optional[torch.Tensor] = None,
                        rp: Optional[torch.Tensor] = None,
                        ctx_len: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact speculative acceptance over one verify pass (the reference's
    ``spec_verify_batched``): logits [B, S, V] f32 (position j is the
    distribution after input j), drafts [B, K = S-1] (point-mass
    proposals), keys [B, 2], per-row options [B], max_accept [B] budget
    caps, the repeat-penalty ``ring`` [B, R] with ``rp`` [B] and
    ``ctx_len`` [B] (the pre-advance lengths).

    Draft j is accepted with probability p_warped(draft j) (greedy rows:
    iff it is the argmax of the penalised logits); at the first
    probabilistic rejection the correction samples the warped
    distribution with the draft removed, renormalised; a stop forced by
    the cap, or the all-accepted bonus position, samples it unmodified.
    Greedy rows are bit-exact with sequential greedy decoding. The
    uniforms come from the row's key at counters ``c .. c+K`` (the
    correction's first), and the key advances by K + 1. No host sync.

    Returns (accepted [B] in [0, K], correction [B], advanced keys)."""
    B, S, V = logits.shape
    K = S - 1
    if ring is not None:
        logits = _chain_penalty(logits, drafts, ring, rp, ctx_len)[0]
    order, wprobs = _top_warp(logits, temperature, top_k, top_p, top_c)
    ctr = keys[:, 1:2] + torch.arange(K + 1, device=keys.device)[None, :]
    u = _hash_uniform(keys[:, :1], ctr)                  # [B, K+1]
    greedy_row = temperature <= 0.0
    argmax_tok = logits.argmax(dim=-1)                   # [B, S]
    drafts = drafts.long()
    p_draft = torch.where(order[:, :K] == drafts[:, :, None],
                          wprobs[:, :K], 0.0).sum(dim=-1)  # [B, K]
    ok = torch.where(greedy_row[:, None], drafts == argmax_tok[:, :K],
                     u[:, 1:] < p_draft)
    ok = ok & (torch.arange(K, device=ok.device)[None, :]
               < max_accept.long()[:, None])
    accepted = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    probs_j, order_j = _at(wprobs, accepted), _at(order, accepted)
    prob_rejected = accepted < max_accept.long().clamp(max=K)
    if K > 0:
        dr = drafts.gather(1, accepted.clamp(max=K - 1)[:, None])[:, 0]
    else:
        dr = torch.zeros_like(accepted)
    drop = (order_j == dr[:, None]) & prob_rejected[:, None]
    resid = torch.where(drop, 0.0, probs_j)
    resid = resid / resid.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    sampled = order_j.gather(1, _draw(resid, u[:, 0])[:, None])[:, 0]
    g_corr = argmax_tok.gather(1, accepted[:, None])[:, 0]
    correction = torch.where(greedy_row, g_corr, sampled)
    new_keys = torch.stack([keys[:, 0], keys[:, 1] + K + 1], dim=1)
    return accepted, correction, new_keys


def spec_verify_tree(logits: torch.Tensor, drafts: torch.Tensor,
                     sib_tok: torch.Tensor, sib_node: torch.Tensor,
                     keys: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     max_accept: torch.Tensor, top_c: int = 64,
                     ring: Optional[torch.Tensor] = None,
                     rp: Optional[torch.Tensor] = None,
                     ctx_len: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Tree-speculation acceptance (the reference's ``spec_verify_tree``):
    logits [B, N, V] over the node tree (node 0 the root, 1..K the main
    chain, the rest sibling leaves); drafts [B, K]; sib_tok/sib_node
    [B, K] the sibling token at main position j and its node (-1 = none).

    The main chain is accepted exactly as :func:`spec_verify_batched`;
    at the first probabilistic rejection a0 the sibling there gets one
    more exact test (greedy: iff it is the penalised argmax; sampled:
    with probability p(sib) / (1 - p(draft))). An accepted sibling's
    correction samples the sibling node's own warped distribution; a
    rejected one is also removed from the residual at a0. Penalty counts
    follow the accepted path. Uniforms: counters ``c`` (correction),
    ``c+1`` (sibling), ``c+2 .. c+K+1`` (drafts); the key advances by
    K + 2. No host sync.

    Returns (accepted [B] including a used sibling, used_sib [B] 0/1,
    correction [B], advanced keys [B, 2])."""
    B, N, V = logits.shape
    K = drafts.shape[1]
    main = logits[:, :K + 1]
    drafts = drafts.long()
    if ring is not None:
        main, in_cnt, ev_pref, dr_pref = _chain_penalty(main, drafts, ring,
                                                        rp, ctx_len)
    order, wprobs = _top_warp(main, temperature, top_k, top_p, top_c)
    ctr = keys[:, 1:2] + torch.arange(K + 2, device=keys.device)[None, :]
    u = _hash_uniform(keys[:, :1], ctr)                  # [B, K+2]
    greedy_row = temperature <= 0.0
    argmax_tok = main.argmax(dim=-1)                     # [B, K+1]
    p_draft = torch.where(order[:, :K] == drafts[:, :, None],
                          wprobs[:, :K], 0.0).sum(dim=-1)
    ok = torch.where(greedy_row[:, None], drafts == argmax_tok[:, :K],
                     u[:, 2:] < p_draft)
    ok = ok & (torch.arange(K, device=ok.device)[None, :]
               < max_accept.long()[:, None])
    a0 = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    probs_j, order_j = _at(wprobs, a0), _at(order, a0)
    prob_rejected = a0 < max_accept.long().clamp(max=K)
    m = a0.clamp(max=K - 1)[:, None]
    dr = drafts.gather(1, m)[:, 0]
    st = sib_tok.long().gather(1, m)[:, 0]
    sn = sib_node.long().gather(1, m)[:, 0]
    has_sib = prob_rejected & (sn >= 0)
    g_tok = argmax_tok.gather(1, a0[:, None])[:, 0]
    p_rej = p_draft.gather(1, m)[:, 0]
    p_sib = torch.where(order_j == st[:, None], probs_j, 0.0).sum(dim=-1)
    ratio = (p_sib / (1.0 - p_rej).clamp(min=1e-20)).clamp(max=1.0)
    sib_ok = torch.where(greedy_row, st == g_tok, u[:, 1] < ratio)
    used_sib = has_sib & sib_ok
    sib_logits = _at(logits, sn.clamp(0, N - 1))         # [B, V]
    if ring is not None:
        ev_s = _at(ev_pref, (a0 + 1).clamp(max=K))
        dr_s = _at(dr_pref, a0)
        cnt_s = in_cnt - ev_s + dr_s + _counts(st[:, None], V)
        sib_logits = _penalise(sib_logits, cnt_s, rp)
    order_sib, wprobs_sib = _top_warp(sib_logits[:, None], temperature,
                                      top_k, top_p, top_c)
    order_sib, wprobs_sib = order_sib[:, 0], wprobs_sib[:, 0]
    drop = (((order_j == dr[:, None]) & prob_rejected[:, None])
            | ((order_j == st[:, None]) & (has_sib & ~sib_ok)[:, None]))
    resid = torch.where(drop, 0.0, probs_j)
    probs_f = torch.where(used_sib[:, None], wprobs_sib, resid)
    order_f = torch.where(used_sib[:, None], order_sib, order_j)
    probs_f = probs_f / probs_f.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    sampled = order_f.gather(1, _draw(probs_f, u[:, 0])[:, None])[:, 0]
    g_corr = torch.where(used_sib, sib_logits.argmax(dim=-1), g_tok)
    correction = torch.where(greedy_row, g_corr, sampled)
    accepted = a0 + used_sib.long()
    new_keys = torch.stack([keys[:, 0], keys[:, 1] + K + 2], dim=1)
    return accepted, used_sib.long(), correction, new_keys
