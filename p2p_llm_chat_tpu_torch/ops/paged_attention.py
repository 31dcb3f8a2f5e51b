"""Decode-append attention over the paged KV pool: kernel B
(csrc/paged_attention.cu) and its plain version.

One query token per row attends its pool window (positions < ``lengths``,
walked through the page table) plus the current token's own (k_cur,
v_cur), which is not in the pool yet: the model lands the whole step's
k/v after the layer loop (models/llama.decode_step_paged). On int8 pools
the k scales fold into the scores and the v scales into the
probabilities of the numerator only.

The reference splits this op by window on the TPU (an XLA gather at short
windows, the Pallas ``_paged_attention_flash_append`` at long ones); that
split and its VMEM budgets are TPU artifacts. Here one split-K kernel
serves every window. :func:`paged_attention_append` launches it for CUDA
tensors (or raises) and runs :func:`paged_attention_append_reference`
only for tensors on the CPU. ``paged_attention_append.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_kv import PagedKVCache

NEG_INF = -1e30
# Tokens per split-K slice of kernel B: one block per (row, kv head, 512
# tokens), so a window of W tokens spreads over ceil(W / 512) blocks.
SPLIT_TOKENS = 512


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


def paged_attention_append_reference(q: torch.Tensor, k_cur: torch.Tensor,
                                     v_cur: torch.Tensor,
                                     cache: PagedKVCache,
                                     lengths: torch.Tensor, layer: int, *,
                                     pages: int) -> torch.Tensor:
    """Plain PyTorch version (the reference's gather + merge math).

    q [B, Hq, D]; k_cur/v_cur [B, Hkv, D]; lengths [B] tokens already in
    the pool (NOT counting the current token). Dead window positions are
    zeroed before the p.v product: a garbage page may hold NaN/Inf, and
    0 * NaN would poison the row. Returns [B, Hq, D] in q.dtype."""
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
    v = torch.where(mask[:, :, None, None], v, torch.zeros((), dtype=v.dtype,
                                                           device=v.device))
    if sv is not None:
        sv = torch.where(mask[:, None, :], sv, torch.zeros((), device=sv.device))
        pv = torch.einsum("bgrst,btgd->bgrsd",
                          (p * sv[:, :, None, None, :]).to(q.dtype),
                          v.to(q.dtype)).float()
    else:
        pv = torch.einsum("bgrst,btgd->bgrsd", p.to(v.dtype), v).float()
    num = pv + p_cur * v_cur.float()[:, :, None, None, :]
    den = p.sum(dim=-1, keepdim=True) + p_cur
    out = num / den
    return out[:, :, :, 0].reshape(B, Hq, D).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_append_launch.restype = i
    lib.paged_append_launch.argtypes = (
        [p] * 8 + [i, p, p, p, p] + [i] * 12 + [p])


def paged_attention_append(q: torch.Tensor, k_cur: torch.Tensor,
                           v_cur: torch.Tensor, cache: PagedKVCache,
                           lengths: torch.Tensor, layer: int, *,
                           pages: int) -> torch.Tensor:
    """Decode attention for one layer: q [B, Hq, D], k_cur/v_cur
    [B, Hkv, D] (bf16 on the card), the pool window of ``pages`` table
    entries per row, ``lengths`` [B] int32 tokens in the pool. Returns
    [B, Hq, D] in q.dtype."""
    if q.device.type == "cpu":
        return paged_attention_append_reference(q, k_cur, v_cur, cache,
                                                lengths, layer, pages=pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_append: unsupported device "
                         f"{q.device}")
    B, Hq, D = q.shape
    L, N, ps, Hkv, Dp = cache.k.shape
    for name, t in (("q", q), ("k_cur", k_cur), ("v_cur", v_cur)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"paged_attention_append: {name} must be a "
                             "contiguous bf16 tensor on q's device")
    if (k_cur.shape != (B, Hkv, D) or v_cur.shape != (B, Hkv, D) or Dp != D
            or Hq % Hkv or D not in (32, 64, 128) or Hq // Hkv > 8):
        raise ValueError(f"paged_attention_append: unsupported geometry q "
                         f"{tuple(q.shape)} pool {tuple(cache.k.shape)}")
    quantized = cache.quantized
    want = torch.int8 if quantized else torch.bfloat16
    if cache.k.dtype != want or cache.v.dtype != want:
        raise ValueError(f"paged_attention_append: pool must be {want}")
    pt, ln = cache.page_table, lengths
    if (pt.dtype != torch.int32 or ln.dtype != torch.int32
            or not pt.is_contiguous() or not ln.is_contiguous()
            or pt.shape[0] != B or ln.shape != (B,)
            or not 1 <= pages <= pt.shape[1] or not 0 <= layer < L):
        raise ValueError("paged_attention_append: page_table [B, P] and "
                         "lengths [B] must be contiguous int32, with "
                         "1 <= pages <= P and 0 <= layer < L")
    if quantized:
        ks, vs = cache.k_scale, cache.v_scale
        if ks.dtype != torch.float32 or not ks.is_contiguous() \
                or not vs.is_contiguous():
            raise ValueError("paged_attention_append: scales must be "
                             "contiguous f32")
        ks_ptr, vs_ptr, ps_pad = ks.data_ptr(), vs.data_ptr(), ks.shape[-1]
    else:
        ks_ptr, vs_ptr, ps_pad = None, None, ps
    splits = max(1, -(-(pages * ps) // SPLIT_TOKENS))
    ws_acc = torch.empty((B, Hq, splits, D), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((B, Hq, splits, 2), dtype=torch.float32,
                        device=q.device)
    out = torch.empty_like(q)
    lib = _build.load("paged_attention", _bind)
    rc = lib.paged_append_launch(
        q.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(),
        cache.k.data_ptr(), cache.v.data_ptr(), ks_ptr, vs_ptr,
        pt.data_ptr(), pt.shape[1], ln.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, N, ps, ps_pad,
        layer, pages, splits, SPLIT_TOKENS, int(quantized),
        _build.stream_ptr(q.device))
    _build.check(rc, lib, "paged_append_error_string",
                 "paged_attention_append")
    paged_attention_append.launches += 1
    return out


paged_attention_append.launches = 0
