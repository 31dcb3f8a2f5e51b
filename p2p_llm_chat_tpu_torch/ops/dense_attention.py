"""Decode and verify attention over the dense KV cache (the reference's
``SERVE_KV=dense`` path), served by kernel B (csrc/paged_attention.cu).

The reference computes this attention in XLA: ``models/llama._block``
writes the step's k/v into ``cache.k/v[l]`` ([B, max_seq, Hkv, D]) and
runs ``layers.attend_gqa`` over the first ``window`` slots under a length
mask (``decode_step``), a chain mask (``verify_step``) or a tree mask
(``verify_tree``). The port allocates that cache with its slot axis
rounded up to a multiple of the page size ``ps`` = 64 (models/llama.
KVCache: ``T`` slots, the ones at or past max_seq never written nor
attended), so ``[L, B, T, Hkv, D]`` is, bit for bit, the pool
``[L, B * T / ps, ps, Hkv, D]`` under the identity page table
``table[b, i] = b * (T / ps) + i``, whatever ``SERVE_MAX_SEQ`` is. So:

- :func:`dense_attention` (decode, write-then-attend) is kernel B's pool
  mode on a zero-copy view of the cache;
- :func:`dense_attention_verify` (speculative verify, chain or tree) is
  kernel B's verify mode on the same view, with the block's own k/v and
  its mask passed in, as ``verify_step_paged`` passes them;
- :func:`rows_view` is some rows of that view as a paged cache: a
  session wake runs ``verify_step_paged`` on it (kernel B's verify mode
  through ``paged_attention_verify_append``) over the waking rows only.

The identity table is built once per (rows, pages per row, device) and
kept, so the serving loop's CUDA graphs capture it as a constant. Each
wrapper launches kernel B for CUDA tensors (or raises) and runs its plain
version, the reference's math, only for tensors on the CPU;
``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.layers import attend_gqa
from . import paged_attention as pa
from .paged_kv import PagedKVCache

# The identity view's page: the paged pool's default, so kernel B reads
# its table and carries pages as often as on the paged path.
VIEW_PAGE = 64

_tables: dict[tuple, torch.Tensor] = {}


def cache_slots(max_seq: int) -> int:
    """The slot axis a dense cache of ``max_seq`` is allocated with:
    ``max_seq`` rounded up to a multiple of :data:`VIEW_PAGE`."""
    return -(-max_seq // VIEW_PAGE) * VIEW_PAGE


def identity_table(B: int, P: int, device) -> torch.Tensor:
    """[B, P] int32 with ``table[b, i] = b * P + i``, built once and kept
    (graphs captured over it hold its address)."""
    key = (B, P, str(device))
    t = _tables.get(key)
    if t is None:
        if torch.device(device).type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            # Built inside a capture it would hold nothing until a replay.
            raise RuntimeError("dense_attention: the identity table must be "
                               "built by an eager call before a capture")
        t = (torch.arange(B * P, dtype=torch.int32, device=device)
             .reshape(B, P))
        _tables[key] = t
    return t


def pool_view(k: torch.Tensor, v: torch.Tensor):
    """The dense cache k/v ``[L, B, T, Hkv, D]`` (``T`` a multiple of
    :data:`VIEW_PAGE`, as ``KVCache.create`` allocates it) as kernel B's
    pool: (k_pool, v_pool ``[L, B * T / ps, ps, Hkv, D]``, identity table
    [B, T / ps], ps). Views, never copies: the pool's storage is the
    cache's."""
    L, B, T, Hkv, D = k.shape
    ps = VIEW_PAGE
    if T % ps:
        raise ValueError(f"dense_attention: the cache's {T} slots are not "
                         f"a multiple of {ps} (allocate it with "
                         f"KVCache.create)")
    shape = (L, B * (T // ps), ps, Hkv, D)
    return (k.view(shape), v.view(shape),
            identity_table(B, T // ps, k.device), ps)


def rows_view(cache, rows: torch.Tensor, lengths: torch.Tensor
              ) -> PagedKVCache:
    """Rows ``rows`` ([R] long) of the dense cache as a paged cache over
    :func:`pool_view`: the identity table's rows ``rows`` and ``lengths``
    ([R] int32, committed slots per row), no scales. A session wake runs
    the family's ``verify_step_paged`` (kernel B's verify mode) on it over
    the waking rows only: every read and the block's write stay inside
    those rows, at slots below ``T``. Zero-copy k/v; the table is a
    gathered copy (eager callers only)."""
    kp, vp, table, _ = pool_view(cache.k, cache.v)
    return PagedKVCache(k=kp, v=vp, page_table=table[rows.long()],
                        lengths=lengths)


def _live_window(cache_k, cache_v, layer: int, window: int,
                 mask: torch.Tensor):
    """Layer ``layer``'s first ``window`` slots, v zeroed where no query
    attends (a dead slot may hold NaN, which 0 * NaN would let into the
    row; on finite caches this changes nothing). mask: [B, Sq, W]."""
    k = cache_k[layer, :, :window]
    v = cache_v[layer, :, :window]
    seen = mask.any(dim=1)                                    # [B, W]
    v = torch.where(seen[:, :, None, None], v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    return k, v


def dense_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, lengths: torch.Tensor,
                          layer: int, *, window: int) -> torch.Tensor:
    """The reference's decode attention (``attend_gqa`` over
    ``cache.k/v[layer, :, :window]`` under ``length_mask(window,
    lengths)``). q [B, Hq, D]; lengths [B] slots to attend, the one this
    step wrote included. Returns [B, Hq, D] in q.dtype."""
    pos = torch.arange(window, device=q.device)
    mask = pos[None, None, :] < lengths.long()[:, None, None]  # [B, 1, W]
    k, v = _live_window(cache_k, cache_v, layer, window, mask)
    return attend_gqa(q[:, None], k, v, mask[:, None])[:, 0].to(q.dtype)


def dense_attention(q: torch.Tensor, cache, lengths: torch.Tensor,
                    layer: int, *, window: int) -> torch.Tensor:
    """Decode attention for one layer over the dense cache, write-then-
    attend: the step's k/v already sit at slot ``lengths - 1`` of each
    row. q [B, Hq, D]; ``cache`` holds k/v ``[L, B, T, Hkv, D]``;
    lengths [B] int32 slots to attend (``cache.lengths + 1``); ``window``
    (<= max_seq) covers every row's lengths.

    On the card: kernel B's pool mode over :func:`pool_view` (bf16
    caches), ``ceil(window / ps)`` pages per row. On the CPU:
    :func:`dense_attention_plain`. Returns [B, Hq, D] in q.dtype."""
    if q.device.type == "cpu":
        return dense_attention_plain(q, cache.k, cache.v, lengths, layer,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"dense_attention: unsupported device {q.device}")
    kp, vp, table, ps = pool_view(cache.k, cache.v)
    out = pa._launch("dense_attention", q, None, None, kp, vp, None, None,
                     table, lengths, layer, -(-window // ps))
    dense_attention.launches += 1
    return out


def verify_mask(lengths: torch.Tensor, S: int, window: int,
                block_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's verify mask over the window, [B, S, W] bool: query
    j of row b sees every committed slot (< ``lengths[b]``) and the block
    slots ``lengths[b] + i`` with ``block_mask[b, j, i]`` (None = the
    chain i <= j, ``verify_step``'s ``arange(W) <= lengths + j``; a tree's
    ancestor matrix gives ``tree_attention_mask``)."""
    dev = lengths.device
    cols = torch.arange(window, device=dev)[None, :]
    ln = lengths.long()[:, None]
    committed = cols < ln                                     # [B, W]
    jr = cols - ln
    in_blk = (jr >= 0) & (jr < S)
    if block_mask is None:
        block_mask = torch.ones((S, S), dtype=torch.bool,
                                device=dev).tril()[None].expand(
                                    lengths.shape[0], S, S)
    blk = block_mask.gather(2, jr.clamp(0, S - 1)[:, None, :].expand(
        -1, S, -1))                                           # [B, S, W]
    return committed[:, None, :] | (in_blk[:, None, :] & blk)


def dense_attention_verify_plain(q_blk, k_blk, v_blk, cache_k, cache_v,
                                 lengths, layer: int, *, window: int,
                                 block_mask=None) -> torch.Tensor:
    """The reference's verify attention: the block's k/v placed at slots
    ``lengths + i`` of the window (slots at or past ``window`` drop), then
    ``attend_gqa`` under :func:`verify_mask`. Returns [B, S, Hq, D]."""
    B, S = q_blk.shape[:2]
    mask = verify_mask(lengths, S, window, block_mask)        # [B, S, W]
    k = cache_k[layer, :, :window].clone()
    v = cache_v[layer, :, :window].clone()
    pos = lengths.long()[:, None] + torch.arange(S, device=q_blk.device)
    b_idx = torch.arange(B, device=q_blk.device)[:, None].expand(B, S)
    keep = pos < window
    k[b_idx[keep], pos[keep]] = k_blk[keep].to(k.dtype)
    v[b_idx[keep], pos[keep]] = v_blk[keep].to(v.dtype)
    seen = mask.any(dim=1)
    v = torch.where(seen[:, :, None, None], v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    return attend_gqa(q_blk, k, v, mask[:, None]).to(q_blk.dtype)


def dense_attention_verify(q_blk: torch.Tensor, k_blk: torch.Tensor,
                           v_blk: torch.Tensor, cache,
                           lengths: torch.Tensor, layer: int, *,
                           window: int,
                           block_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Speculative-verify attention for one layer over the dense cache:
    S candidate positions per row (q_blk [B, S, Hq, D]; their k/v
    k_blk/v_blk [B, S, Hkv, D]) attend the committed slots below
    ``lengths`` ([B] int32, the block not counted) and the block under
    ``block_mask`` ([B, S, S] bool; None = the chain, a tree passes its
    ancestor matrix). ``window`` covers ``lengths + S``.

    On the card: kernel B's verify mode over :func:`pool_view` (bf16
    caches), the block's own k/v at full precision. On the CPU:
    :func:`dense_attention_verify_plain`. Returns [B, S, Hq, D]."""
    if q_blk.device.type == "cpu":
        return dense_attention_verify_plain(
            q_blk, k_blk, v_blk, cache.k, cache.v, lengths, layer,
            window=window, block_mask=block_mask)
    if q_blk.device.type != "cuda":
        raise ValueError(f"dense_attention_verify: unsupported device "
                         f"{q_blk.device}")
    kp, vp, table, ps = pool_view(cache.k, cache.v)
    out = pa.verify_launch("dense_attention_verify", q_blk, k_blk, v_blk,
                           kp, vp, None, None, table, lengths, layer,
                           -(-window // ps), block_mask)
    dense_attention_verify.launches += 1
    return out


dense_attention.launches = 0
dense_attention_verify.launches = 0
