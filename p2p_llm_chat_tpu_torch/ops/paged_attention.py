"""Attention over the paged KV pool: kernel B (csrc/paged_attention.cu)
in its decode modes and its verify mode, and the plain versions.

- Append mode, :func:`paged_attention_append`: one query token per row
  attends its pool window (positions < ``lengths``, walked through the
  page table) plus the current token's own (k_cur, v_cur), which is not
  in the pool yet: the model lands the whole step's k/v after the layer
  loop (models/llama.decode_step_paged's default branch).
- Pool mode, :func:`paged_attention`: write-then-attend. The caller has
  already written this step's k/v into the pool (ops/paged_kv.
  write_decode) and passes ``lengths`` counting it, so the window alone
  is attended (the branch ``PAGED_ATTN_IMPL=kernel|flash`` selects).
- Verify mode, :func:`paged_attention_verify_append`: S <= 512 positions
  per row attend the window plus the block's own k/v under a chain or
  tree mask (speculative and tree verify, session wakes, the drafter's
  catch-up feeds); its own kernel, its workspace sized by
  :func:`verify_plan`.

On int8 pools the k scales fold into the scores and the v scales into
the probabilities of the numerator only.

The reference splits each function by TPU strategy: the append function
into an XLA gather, the Pallas ``_paged_append_kernel_call`` over a
gathered window and the Pallas ``_paged_attention_flash_append``; the
pool function into an XLA gather, the Pallas ``_paged_attention_kernel``
(grid (B, pages)) and ``_paged_attention_flash`` (a per-row chunk loop).
Those splits, and their VMEM and DMA budgets, are TPU artifacts: here one
kernel (a split over fixed slices of the window, then a combine) serves
every window and every impl. The impl names are still read under the
reference's env names and defaults (``PAGED_ATTN_IMPL``,
``PAGED_APPEND_IMPL``, both ``gather``), because they choose the model's
branch and the reference's refusals: an int8 pool is served only under
the gather attention impl.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs a
plain version only for tensors on the CPU; ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from ..utils.env import env_or
from .paged_kv import PagedKVCache

NEG_INF = -1e30
IMPLS = ("gather", "kernel", "flash")
# Process-wide defaults, read at import under the reference's names
# (p2p_llm_chat_tpu/ops/paged_attention.py:108, :403). The attention
# impl picks decode_step_paged's branch: ``gather`` = attend-then-write
# (append mode), ``kernel``/``flash`` = write-then-attend (pool mode).
# Engines built from the env read PAGED_ATTN_IMPL anew at each build and
# pass it down explicitly (serve/engine.py).
_DEFAULT_IMPL = env_or("PAGED_ATTN_IMPL", "gather")
_APPEND_IMPL = env_or("PAGED_APPEND_IMPL", "gather")


def check_impl(impl: str, what: str = "PAGED_ATTN_IMPL") -> str:
    """``impl`` if it names one of :data:`IMPLS`, else ValueError."""
    if impl not in IMPLS:
        raise ValueError(f"{what} must be gather|kernel|flash, got {impl!r}")
    return impl


def _gather_window_scores(q4, k_pages, v_pages, k_scale, v_scale,
                          page_table, lengths, layer: int, pages: int):
    """Gather one layer's window and compute masked pre-softmax scores (k
    scales folded in for int8 pools). Returns (scores [B,G,rep,S,W] f32,
    v [B,W,Hkv,D], sv [B,G,W] | None, mask [B,W]). The math of the
    reference's ``_gather_window_scores``."""
    B, S, Hq, D = q4.shape
    L, N, ps, Hkv, _ = k_pages.shape
    rep = Hq // Hkv
    W = pages * ps
    pt = page_table[:, :pages].long()
    k = k_pages[layer][pt].reshape(B, W, Hkv, D)
    v = v_pages[layer][pt].reshape(B, W, Hkv, D)
    qg = q4.reshape(B, S, Hkv, rep, D)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                          k.to(q4.dtype).float()) / math.sqrt(D)
    sv = None
    if k_scale is not None:
        sk = k_scale[layer][pt][..., :ps].transpose(1, 2).reshape(B, Hkv, W)
        sv = v_scale[layer][pt][..., :ps].transpose(1, 2).reshape(B, Hkv, W)
        scores = scores * sk[:, :, None, None, :]
    mask = (torch.arange(W, device=q4.device)[None, :]
            < lengths[:, None].long())                        # [B, W]
    scores = torch.where(mask[:, None, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q4.device))
    return scores, v, sv, mask


def _live(v: torch.Tensor, sv, mask: torch.Tensor):
    """Zero the dead window positions of v [B, W, Hkv, D] (and of the v
    scales sv [B, G, W]): positions past ``lengths`` are skipped, and a
    garbage page may hold NaN/Inf, which 0 * NaN would let into the row.
    On finite pools this changes nothing."""
    v = torch.where(mask[:, :, None, None], v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    if sv is not None:
        sv = torch.where(mask[:, None, :], sv,
                         torch.zeros((), device=sv.device))
    return v, sv


def paged_attention_append_reference(q: torch.Tensor, k_cur: torch.Tensor,
                                     v_cur: torch.Tensor,
                                     cache: PagedKVCache,
                                     lengths: torch.Tensor, layer: int, *,
                                     pages: int) -> torch.Tensor:
    """Plain PyTorch version of the append function (the reference's
    gather + merge math).

    q [B, Hq, D]; k_cur/v_cur [B, Hkv, D]; lengths [B] tokens already in
    the pool (NOT counting the current token). Returns [B, Hq, D] in
    q.dtype."""
    B, Hq, D = q.shape
    Hkv = k_cur.shape[1]
    rep = Hq // Hkv
    scores, v, sv, mask = _gather_window_scores(
        q[:, None], cache.k, cache.v, cache.k_scale, cache.v_scale,
        cache.page_table, lengths, layer, pages)
    qg = q.reshape(B, Hkv, rep, D)
    s_cur = torch.einsum("bgrd,bgd->bgr", qg.float(),
                         k_cur.float()) / math.sqrt(D)
    s_cur = s_cur[..., None, None]                             # [B,G,rep,1,1]
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_cur)
    p = torch.exp(scores - m)
    p_cur = torch.exp(s_cur - m)
    v, sv = _live(v, sv, mask)
    if sv is not None:
        pv = torch.einsum("bgrst,btgd->bgrsd",
                          (p * sv[:, :, None, None, :]).to(q.dtype),
                          v.to(q.dtype)).float()
    else:
        pv = torch.einsum("bgrst,btgd->bgrsd", p.to(v.dtype), v).float()
    num = pv + p_cur * v_cur.float()[:, :, None, None, :]
    den = p.sum(dim=-1, keepdim=True) + p_cur
    out = num / den
    return out[:, :, :, 0].reshape(B, Hq, D).to(q.dtype)


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor, layer: int, *,
                              pages: int) -> torch.Tensor:
    """The oracle of the pool function (reference :1164-1184): every
    window slot fetched one by one through the page table (no whole-page
    reshape), then masked ``attend_gqa``. q [B, Hq, D]; pools
    [L, N, ps, Hkv, D] (bf16 or f32); lengths [B] tokens to attend,
    the slot this step wrote included."""
    from ..models.layers import attend_gqa
    B, ps = q.shape[0], k_pages.shape[2]
    pos = torch.arange(pages * ps, device=q.device)
    phys = page_table[:, :pages].long()[:, pos // ps]          # [B, W]
    slot = (pos % ps)[None, :].expand(B, -1)
    k = k_pages[layer][phys, slot]                             # [B,W,Hkv,D]
    mask = pos[None, :] < lengths[:, None].long()              # [B, W]
    v, _ = _live(v_pages[layer][phys, slot], None, mask)
    return attend_gqa(q[:, None], k, v, mask[:, None, None, :])[:, 0].to(
        q.dtype)


def _paged_attention_gather(q, k_pages, v_pages, page_table, lengths,
                            layer: int, *, pages: int) -> torch.Tensor:
    """The gather impl (reference :196-214): whole pages gathered, f32
    scores and softmax, the probabilities cast to the pool dtype for p.v
    (``attend_gqa``'s precision)."""
    B, Hq, D = q.shape
    scores, v, _, mask = _gather_window_scores(
        q[:, None], k_pages, v_pages, None, None, page_table, lengths,
        layer, pages)
    v, _ = _live(v, None, mask)
    out = torch.einsum("bgrst,btgd->bsgrd",
                       torch.softmax(scores, dim=-1).to(v.dtype), v)
    return out.reshape(B, Hq, D).to(q.dtype)


def _paged_attention_gather_quant(q, k_pages, v_pages, k_scale, v_scale,
                                  page_table, lengths, layer: int, *,
                                  pages: int) -> torch.Tensor:
    """The gather impl over an int8 pool (reference :536-556): scores x
    k scales, softmax, probabilities x v scales, p.v in q's dtype."""
    B, Hq, D = q.shape
    scores, v, sv, mask = _gather_window_scores(
        q[:, None], k_pages, v_pages, k_scale, v_scale, page_table, lengths,
        layer, pages)
    v, sv = _live(v, sv, mask)
    probs = torch.softmax(scores, dim=-1) * sv[:, :, None, None, :]
    out = torch.einsum("bgrst,btgd->bsgrd", probs.to(q.dtype),
                       v.to(q.dtype))
    return out.reshape(B, Hq, D)


def _paged_attention_f32(q, k_pages, v_pages, page_table, lengths,
                         layer: int, *, pages: int) -> torch.Tensor:
    """The kernel and flash impls' function (reference
    ``_paged_attention_kernel`` :160 and ``_paged_attention_flash``
    :1086): the gather impl's, with p.v in f32 as the Pallas kernels
    compute it."""
    B, Hq, D = q.shape
    scores, v, _, mask = _gather_window_scores(
        q[:, None], k_pages, v_pages, None, None, page_table, lengths,
        layer, pages)
    v, _ = _live(v, None, mask)
    out = torch.einsum("bgrst,btgd->bsgrd", torch.softmax(scores, dim=-1),
                       v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_append_launch.restype = i
    lib.paged_append_launch.argtypes = (
        [p] * 8 + [i, p, p, p, p] + [i] * 11 + [p])
    lib.paged_pool_launch.restype = i
    lib.paged_pool_launch.argtypes = (
        [p] * 6 + [i, p, p, p, p] + [i] * 11 + [p])
    lib.paged_split_smem.restype = i
    lib.paged_split_smem.argtypes = [i, i]
    lib.paged_slice_tokens.restype = i
    lib.paged_slice_tokens.argtypes = []
    lib.paged_verify_launch.restype = i
    lib.paged_verify_launch.argtypes = (
        [p] * 9 + [i, p, p, p, p] + [i] * 12 + [p])
    lib.paged_verify_max_s.restype = i
    lib.paged_verify_max_s.argtypes = []
    lib.paged_verify_slice_tokens.restype = i
    lib.paged_verify_slice_tokens.argtypes = [i]
    lib.paged_verify_smem.restype = i
    lib.paged_verify_smem.argtypes = [i, i]


def _pool_operands(what: str, q, Hkv: int, D: int, k_pages, v_pages,
                   k_scale, v_scale, page_table, lengths, layer: int,
                   pages: int) -> tuple:
    """Check the pool, table, lengths and scales kernel B reads for ``q``
    (whose dim 0 is B) and return (scale pointers, ps_pad, quantized)."""
    B = q.shape[0]
    L, N, ps, _, _ = k_pages.shape
    quantized = k_scale is not None
    want = torch.int8 if quantized else torch.bfloat16
    if (k_pages.dtype != want or v_pages.dtype != want
            or v_pages.shape != k_pages.shape or not k_pages.is_contiguous()
            or not v_pages.is_contiguous() or k_pages.device != q.device
            or v_pages.device != q.device):
        raise ValueError(f"{what}: pools must be contiguous {want} of one "
                         "shape on q's device")
    pt, ln = page_table, lengths
    if (pt.dtype != torch.int32 or ln.dtype != torch.int32
            or not pt.is_contiguous() or not ln.is_contiguous()
            or pt.device != q.device or ln.device != q.device
            or pt.shape[0] != B or ln.shape != (B,)
            or not 1 <= pages <= pt.shape[1] or not 0 <= layer < L):
        raise ValueError(f"{what}: page_table [B, P] and lengths [B] must "
                         "be contiguous int32 on q's device, with "
                         "1 <= pages <= P and 0 <= layer < L")
    if not quantized:
        return (None, None), ps, False
    ks, vs = k_scale, v_scale
    if (ks.dtype != torch.float32 or vs.dtype != torch.float32
            or not ks.is_contiguous() or not vs.is_contiguous()
            or ks.shape != vs.shape or ks.shape[:3] != (L, N, Hkv)
            or ks.shape[3] < ps or ks.device != q.device
            or vs.device != q.device):
        raise ValueError(f"{what}: scales must be contiguous f32 "
                         "[L, N, Hkv, ps_pad] on q's device")
    return (ks.data_ptr(), vs.data_ptr()), ks.shape[-1], True


def _check_bf16(what: str, q, named) -> None:
    for name, t in named:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a contiguous bf16 "
                             "tensor on q's device")


def _workspace(lib, rows: int, D: int, window: int, device):
    """(splits, f32 workspace) for ``rows`` query rows: one block per
    (row, kv head, slice of the source's SLICE tokens at fixed absolute
    positions), so the slice count follows the window alone; the slices'
    accumulators [rows, splits, D], then their (m, l) [rows, splits, 2]."""
    splits = max(1, -(-window // lib.paged_slice_tokens()))
    ws = torch.empty(rows * splits * (D + 2), dtype=torch.float32,
                     device=device)
    return splits, ws


def verify_plan(width: int, B: int, S: int, Hq: int, D: int,
                window: int) -> tuple[int, int]:
    """(window slices, workspace floats) of a verify-mode call whose
    window slices are ``width`` tokens at fixed absolute positions (the
    source's ``paged_verify_slice_tokens(S)``: fixed by S alone, never by
    B or the window, so a row's answer is bitwise the same at any B and
    window): one partial per (row, position, query head) for each slice
    plus one for the block's own k/v, as accumulators
    [B, S, Hq, slices + 1, D], then (m, l) [B, S, Hq, slices + 1, 2]."""
    splits = max(1, -(-window // width))
    return splits, B * S * Hq * (splits + 1) * (D + 2)


def _launch(what: str, q, k_cur, v_cur, k_pages, v_pages, k_scale, v_scale,
            page_table, lengths, layer: int, pages: int) -> torch.Tensor:
    """Check the operands and launch kernel B: append mode with
    ``k_cur``/``v_cur``, pool mode without."""
    B, Hq, D = q.shape
    L, N, ps, Hkv, Dp = k_pages.shape
    cur = () if k_cur is None else (("k_cur", k_cur), ("v_cur", v_cur))
    _check_bf16(what, q, (("q", q),) + cur)
    if (any(t.shape != (B, Hkv, D) for _, t in cur) or Dp != D
            or Hq % Hkv or D not in (32, 64, 128) or Hq // Hkv > 8):
        raise ValueError(f"{what}: unsupported geometry q {tuple(q.shape)} "
                         f"pool {tuple(k_pages.shape)}")
    (ks_ptr, vs_ptr), ps_pad, quantized = _pool_operands(
        what, q, Hkv, D, k_pages, v_pages, k_scale, v_scale, page_table,
        lengths, layer, pages)
    pt, ln = page_table, lengths
    lib = _build.load("paged_attention", _bind)
    splits, ws = _workspace(lib, B * Hq, D, pages * ps, q.device)
    out = torch.empty_like(q)
    acc_ptr = ws.data_ptr()
    tail = (pt.data_ptr(), pt.shape[1], ln.data_ptr(), acc_ptr,
            acc_ptr + B * Hq * splits * D * 4, out.data_ptr(), B, Hq, Hkv,
            D, N, ps, ps_pad, layer, pages, splits, int(quantized),
            _build.stream_ptr(q.device))
    if k_cur is None:
        rc = lib.paged_pool_launch(q.data_ptr(), k_pages.data_ptr(),
                                   v_pages.data_ptr(), ks_ptr, vs_ptr, *tail)
    else:
        rc = lib.paged_append_launch(q.data_ptr(), k_cur.data_ptr(),
                                     v_cur.data_ptr(), k_pages.data_ptr(),
                                     v_pages.data_ptr(), ks_ptr, vs_ptr,
                                     *tail)
    _build.check(rc, lib, "paged_append_error_string", what)
    return out


def paged_attention_append(q: torch.Tensor, k_cur: torch.Tensor,
                           v_cur: torch.Tensor, cache: PagedKVCache,
                           lengths: torch.Tensor, layer: int, *,
                           pages: int) -> torch.Tensor:
    """Decode attention for one layer, append mode: q [B, Hq, D],
    k_cur/v_cur [B, Hkv, D] (bf16 on the card), the pool window of
    ``pages`` table entries per row, ``lengths`` [B] int32 tokens in the
    pool. Returns [B, Hq, D] in q.dtype.

    ``PAGED_APPEND_IMPL`` (gather | kernel | flash, read at import into
    ``_APPEND_IMPL``) names the reference's three implementations of this
    one function (reference :403-469); each launches kernel B's append
    mode on the card, and the plain version runs on the CPU."""
    check_impl(_APPEND_IMPL, "PAGED_APPEND_IMPL")
    if q.device.type == "cpu":
        return paged_attention_append_reference(q, k_cur, v_cur, cache,
                                                lengths, layer, pages=pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_append: unsupported device "
                         f"{q.device}")
    out = _launch("paged_attention_append", q, k_cur, v_cur, cache.k,
                  cache.v, cache.k_scale, cache.v_scale, cache.page_table,
                  lengths, layer, pages)
    paged_attention_append.launches += 1
    return out


def _pool_impl(impl, k_scale) -> str:
    impl = check_impl(_DEFAULT_IMPL if impl is None else impl, "impl")
    if k_scale is not None and impl != "gather":
        raise ValueError(
            f"int8 KV pools support impl='gather' only, got {impl!r}")
    return impl


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths,
                          layer: int, *, pages: int, impl: str | None = None,
                          k_scale=None, v_scale=None) -> torch.Tensor:
    """The plain version of :func:`paged_attention` for ``impl`` (what
    the wrapper runs on CPU tensors; it runs on any device): the gather
    math for ``gather`` (int8 pools: its quantized form), f32 p.v for
    ``kernel``/``flash``."""
    impl = _pool_impl(impl, k_scale)
    if k_scale is not None:
        return _paged_attention_gather_quant(
            q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
            layer, pages=pages)
    plain = (_paged_attention_gather if impl == "gather"
             else _paged_attention_f32)
    return plain(q, k_pages, v_pages, page_table, lengths, layer,
                 pages=pages)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, layer: int, *, pages: int,
                    impl: str | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention for one layer, pool mode (write-then-attend; the
    reference's ``paged_attention``, :1120-1161).

    q [B, Hq, D]; k_pages/v_pages the whole pool [L, N, ps, Hkv, D]
    (``layer`` selects inside the op); page_table [B, >= pages]; lengths
    [B] tokens to attend per row, the slot this step wrote included
    (callers pass ``cache.lengths + 1``); impl gather | kernel | flash
    (None = ``_DEFAULT_IMPL``, from ``PAGED_ATTN_IMPL``). An int8 pool
    passes ``k_scale``/``v_scale`` ([L, N, Hkv, ps_pad] f32) and is
    served under ``impl="gather"`` only, as in the reference.

    On the card every impl launches kernel B's pool mode (bf16 pools, or
    int8 with scales); on the CPU :func:`paged_attention_plain` runs.
    Returns [B, Hq, D] in q.dtype."""
    impl = _pool_impl(impl, k_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths, layer, pages=pages, impl=impl,
                                     k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    out = _launch("paged_attention", q, None, None, k_pages, v_pages,
                  k_scale, v_scale, page_table, lengths, layer, pages)
    paged_attention.launches += 1
    return out


def paged_attention_verify_append_reference(
        q_blk: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
        cache: PagedKVCache, lengths: torch.Tensor, layer: int, *,
        pages: int, block_mask: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """Plain PyTorch version of the verify function (the reference's
    ``paged_attention_verify_append`` math, :635-690): position j of each
    row attends its pool window (positions < ``lengths``, the same mask
    for every j) plus the block positions i where ``block_mask[b, j, i]``
    (default i <= j) from the in-register k/v at full precision, under one
    softmax over both; on int8 pools the k scales fold into the window's
    scores and the v scales into its probabilities. The window's p.v runs
    in q's dtype, the block's in f32.

    q_blk [B, S, Hq, D]; k_blk/v_blk [B, S, Hkv, D]; block_mask [B, S, S]
    bool or None. Returns [B, S, Hq, D] in q_blk.dtype."""
    B, S, Hq, D = q_blk.shape
    Hkv = k_blk.shape[2]
    rep = Hq // Hkv
    scores_w, v_w, sv, mask = _gather_window_scores(
        q_blk, cache.k, cache.v, cache.k_scale, cache.v_scale,
        cache.page_table, lengths, layer, pages)         # [B,G,rep,S,W]
    qg = q_blk.reshape(B, S, Hkv, rep, D)
    scores_b = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                            k_blk.float()) / math.sqrt(D)
    if block_mask is None:
        block_mask = torch.ones((S, S), dtype=torch.bool,
                                device=q_blk.device).tril()[None]
    scores_b = torch.where(block_mask[:, None, None], scores_b,
                           torch.tensor(NEG_INF, device=q_blk.device))
    W = scores_w.shape[-1]
    probs = torch.softmax(torch.cat([scores_w, scores_b], dim=-1), dim=-1)
    p_w, p_b = probs[..., :W], probs[..., W:]
    v_w, sv = _live(v_w, sv, mask)
    if sv is not None:
        p_w = p_w * sv[:, :, None, None, :]
    out = (torch.einsum("bgrst,btgd->bgrsd", p_w.to(q_blk.dtype),
                        v_w.to(q_blk.dtype)).float()
           + torch.einsum("bgrst,btgd->bgrsd", p_b, v_blk.float()))
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q_blk.dtype)


def verify_launch(what: str, q_blk, k_blk, v_blk, k_pages, v_pages,
                  k_scale, v_scale, page_table, lengths, layer: int,
                  pages: int, block_mask) -> torch.Tensor:
    """Check the operands and launch kernel B's verify mode (q_blk
    [B, S, Hq, D] over the pool window below ``lengths`` plus k_blk/v_blk
    under ``block_mask`` [B, S, S] bool or None = the chain). The caller
    counts the launch under its own wrapper."""
    B, S, Hq, D = q_blk.shape
    L, N, ps, Hkv, Dp = k_pages.shape
    _check_bf16(what, q_blk, (("q_blk", q_blk), ("k_blk", k_blk),
                              ("v_blk", v_blk)))
    lib = _build.load("paged_attention", _bind)
    if (k_blk.shape != (B, S, Hkv, D) or v_blk.shape != k_blk.shape
            or Dp != D or Hq % Hkv or D not in (32, 64, 128)
            or Hq // Hkv > 8 or not 1 <= S <= lib.paged_verify_max_s()):
        raise ValueError(f"{what}: unsupported geometry q_blk "
                         f"{tuple(q_blk.shape)} pool {tuple(k_pages.shape)}")
    mask_ptr = None
    if block_mask is not None:
        if (block_mask.shape != (B, S, S) or block_mask.dtype != torch.bool
                or block_mask.device != q_blk.device):
            raise ValueError(f"{what}: block_mask must be [B, S, S] bool "
                             "on q_blk's device")
        block_mask = block_mask.contiguous()
        mask_ptr = block_mask.data_ptr()
    (ks_ptr, vs_ptr), ps_pad, quantized = _pool_operands(
        what, q_blk, Hkv, D, k_pages, v_pages, k_scale, v_scale, page_table,
        lengths, layer, pages)
    splits, floats = verify_plan(lib.paged_verify_slice_tokens(S), B, S, Hq,
                                 D, pages * ps)
    ws = torch.empty(floats, dtype=torch.float32, device=q_blk.device)
    out = torch.empty_like(q_blk)
    acc_ptr = ws.data_ptr()
    pt = page_table
    rc = lib.paged_verify_launch(
        q_blk.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), mask_ptr,
        k_pages.data_ptr(), v_pages.data_ptr(), ks_ptr, vs_ptr,
        pt.data_ptr(), pt.shape[1], lengths.data_ptr(), acc_ptr,
        acc_ptr + B * S * Hq * (splits + 1) * D * 4, out.data_ptr(), B, S,
        Hq, Hkv, D, N, ps, ps_pad, layer, pages, splits, int(quantized),
        _build.stream_ptr(q_blk.device))
    _build.check(rc, lib, "paged_append_error_string", what)
    return out


def paged_attention_verify_append(q_blk: torch.Tensor, k_blk: torch.Tensor,
                                  v_blk: torch.Tensor, cache: PagedKVCache,
                                  lengths: torch.Tensor, layer: int, *,
                                  pages: int,
                                  block_mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Speculative-verify attention for one layer (the reference's
    ``paged_attention_verify_append``, an XLA path there): S candidate
    positions per row attend the pool window below ``lengths`` plus the
    block's own k/v, which is not in the pool yet (the model lands the
    whole block after the layer loop), under ``block_mask`` ([B, S, S]
    bool, True = attend, the diagonal included; None = the chain i <= j;
    tree verify passes its ancestor matrix).

    q_blk [B, S, Hq, D]; k_blk/v_blk [B, S, Hkv, D] (bf16 on the card);
    lengths [B] int32 pool positions (the block not counted). On the card
    it launches kernel B's verify mode; on the CPU
    :func:`paged_attention_verify_append_reference` runs. Returns
    [B, S, Hq, D] in q_blk.dtype."""
    if q_blk.device.type == "cpu":
        return paged_attention_verify_append_reference(
            q_blk, k_blk, v_blk, cache, lengths, layer, pages=pages,
            block_mask=block_mask)
    if q_blk.device.type != "cuda":
        raise ValueError(f"paged_attention_verify_append: unsupported "
                         f"device {q_blk.device}")
    out = verify_launch("paged_attention_verify_append", q_blk, k_blk,
                        v_blk, cache.k, cache.v, cache.k_scale,
                        cache.v_scale, cache.page_table, lengths, layer,
                        pages, block_mask)
    paged_attention_verify_append.launches += 1
    return out


paged_attention_append.launches = 0
paged_attention.launches = 0
paged_attention_verify_append.launches = 0
