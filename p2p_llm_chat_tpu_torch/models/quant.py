"""Weight-only int8 (w8a16) and int4 (w4a16) quantization — the port of
p2p_llm_chat_tpu/models/quant.py.

Storage is the reference's:
- ``QTensor(q: int8[..., in, out], s: f32[..., 1, out])``, symmetric
  per-output-channel scales over the contraction axis;
- ``QTensor4(q: int8[..., in/2, out], s: f32[..., ng, out])``, two
  offset-by-8 nibbles per byte in the split-half layout (byte row i holds
  logical row i low and row i + in/2 high) and one scale per (group of
  in/ng rows, column), clipped to [-7, 7].

Decode is bandwidth-bound, so decode-shaped calls (<= 512 rows) run the
hand-written kernels (ops/quant_mm.py: kernel A for int8, kernel C for
int4, and their expert-batched forms), which read the quantized bytes
only; prefill-shaped calls dequantize the weight once and run a plain
matmul, as the reference's ``_deq_once`` / ``_deq4_once`` + XLA do. A
layer index takes the place of the reference's ``LayerSlice``: a stacked
``[L, in, out]`` (or ``[L, NE, in, out]``) weight is read at that layer
without a slice copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.quant_mm import (dequant4_f32, quant_matmul, quant_matmul4,
                            quant_matmul_experts_stacked,
                            quant_matmul_experts_stacked4, unpack4)

__all__ = ["QTensor", "QTensor4", "quantize", "dequantize", "pack4",
           "unpack4", "quantize4", "dequantize4", "mm", "q_einsum",
           "param_bytes", "quant_mode", "quantize_params"]

# Row threshold for the kernels: decode ticks and short-prompt prefill sit
# at or below it; longer prefill dequantizes once and runs a plain matmul.
_KERNEL_MAX_ROWS = 512


class QTensor(NamedTuple):
    """int8 weight + f32 per-output-channel scale (contraction axis kept
    as size-1 so ``q * s`` broadcasts)."""

    q: torch.Tensor
    s: torch.Tensor


class QTensor4(NamedTuple):
    """Packed int4 weight + f32 group-wise scales: ``q`` int8
    ``[..., K/2, O]``, ``s`` f32 ``[..., ng, O]``. The logical contraction
    dim and the group size derive from the shapes."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self) -> tuple:
        """LOGICAL shape [..., K, O] (not the packed storage shape)."""
        return (*self.q.shape[:-2], 2 * self.q.shape[-2], self.q.shape[-1])

    @property
    def group(self) -> int:
        return 2 * self.q.shape[-2] // self.s.shape[-2]


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d``, correctly rounded on every device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal (one ulp off
    the IEEE quotient at times), so the divisor is a 0-d tensor here."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def quantize(w: torch.Tensor, axis: int = -2) -> QTensor:
    """Symmetric int8 quantization with per-channel scales over ``axis``
    (the matmul contraction axis). The reference's IEEE f32 ops (abs-max
    / 127, round-half-even, clip), so bytes and scales match it exactly
    on the CPU and the card."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, _div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def dequantize(w: QTensor, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    return (w.q.float() * w.s).to(dtype)


def pack4(v: torch.Tensor) -> torch.Tensor:
    """Pack int values in [-8, 7] (``[..., K, O]``, K even) into the
    split-half int8 nibble layout ``[..., K/2, O]``; bytes >= 128 wrap to
    negative int8 explicitly, as the reference does."""
    K = v.shape[-2]
    if K % 2:
        raise ValueError(f"pack4 needs an even contraction dim, got {K}")
    vi = v.to(torch.int32)
    b = (vi[..., :K // 2, :] + 8) | ((vi[..., K // 2:, :] + 8) << 4)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def quantize4(w: torch.Tensor, group: Optional[int] = None) -> QTensor4:
    """Symmetric int4 quantization with group-wise scales over the -2
    (contraction) axis: scale = group-abs-max / 7, values clipped to
    [-7, 7]. ``group`` defaults to 128 with a 64 fallback. The
    reference's IEEE f32 ops, so bytes and scales match it exactly."""
    wf = w.float()
    K, O = wf.shape[-2], wf.shape[-1]
    if group is None:
        group = 128 if K % 128 == 0 else 64
    if K % group or K % 2:
        raise ValueError(f"group {group} must divide even K={K}")
    g = wf.reshape(*wf.shape[:-2], K // group, group, O)
    amax = g.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, _div(amax, 7.0), torch.ones_like(amax))
    qv = torch.clamp(torch.round(g / s), -7, 7).to(torch.int32)
    return QTensor4(q=pack4(qv.reshape(*wf.shape[:-2], K, O)),
                    s=s.squeeze(-2))


def dequantize4(w: QTensor4, dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """The ``dtype`` weight [..., K, O]; stacks are dequantized one
    leading index at a time so the f32 temporaries stay one matrix big."""
    if w.q.ndim <= 2:
        return dequant4_f32(w.q, w.s).to(dtype)
    out = torch.empty(w.shape, dtype=dtype, device=w.q.device)
    for i in range(w.q.shape[0]):
        out[i] = dequantize4(QTensor4(w.q[i], w.s[i]), dtype)
    return out


def _at(w, layer: Optional[int]):
    """``w[layer]`` of a stacked (quantized) weight; ``w`` itself when
    ``layer`` is None."""
    if layer is None:
        return w
    if isinstance(w, (QTensor, QTensor4)):
        return type(w)(w.q[layer], w.s[layer])
    return w[layer]


def mm(x: torch.Tensor, w, layer: Optional[int] = None) -> torch.Tensor:
    """``x @ w`` (``x @ w[layer]`` for a layer-stacked weight) for a plain
    tensor, a :class:`QTensor` or a :class:`QTensor4`."""
    if not isinstance(w, (QTensor, QTensor4)):
        return x @ _at(w, layer)
    lead, H = x.shape[:-1], x.shape[-1]
    rows = x.numel() // H if H else 0
    O = w.q.shape[-1]
    if rows <= _KERNEL_MAX_ROWS:
        kernel = quant_matmul if isinstance(w, QTensor) else quant_matmul4
        y = kernel(x.reshape(rows, H).contiguous(), w.q, w.s, layer)
        return y.reshape(*lead, O)
    w = _at(w, layer)
    if isinstance(w, QTensor):
        return x @ dequantize(w, x.dtype)
    return x @ dequantize4(w, x.dtype)


# Expert einsum specs that are exactly a batched per-expert matmul
# x[e] @ w[e] (contraction at w's -2, out axis last) — the two forms
# models/mixtral.moe_mlp emits and the only ones the expert kernels serve.
_EXPERT_MM_SPECS = frozenset({"ech,ehf->ecf", "ecf,efh->ech"})


def q_einsum(spec: str, x: torch.Tensor, w, layer: Optional[int] = None
             ) -> torch.Tensor:
    """``einsum(spec, x, w)`` (``w[layer]`` for a layer-stacked weight)
    for plain or quantized ``w``. The contraction over ``w`` must be its
    -2 axis and the output must end with ``w``'s out axis.

    A layer-stacked 4-D expert pool read at ``layer`` under one of the
    two batched-matmul specs, with at most 512 rows per bucket, goes to
    the expert kernels; everything else dequantizes and runs
    ``torch.einsum`` (int8 as the reference does: the einsum over the
    int8 values in x.dtype, then the scale)."""
    if not isinstance(w, (QTensor, QTensor4)):
        return torch.einsum(spec, x, _at(w, layer))
    if (layer is not None and w.q.ndim == 4 and x.ndim == 3
            and spec in _EXPERT_MM_SPECS
            and x.shape[1] <= _KERNEL_MAX_ROWS):
        kernel = (quant_matmul_experts_stacked if isinstance(w, QTensor)
                  else quant_matmul_experts_stacked4)
        return kernel(x.contiguous(), w.q, w.s, layer)
    w = _at(w, layer)
    if isinstance(w, QTensor):
        return torch.einsum(spec, x, w.q.to(x.dtype)) * w.s.to(x.dtype)
    return torch.einsum(spec, x, dequantize4(w, x.dtype))


def _int4_group(K: int, expert: bool) -> Optional[int]:
    """Group size for an int4 leaf with contraction ``K``, or None -> the
    leaf keeps int8: 128 with a 64 fallback; expert stacks with a large
    256-divisible contraction group at 256 (the reference's rule)."""
    if K % 2:
        return None
    if expert and K >= 8192 and K % 256 == 0:
        return 256
    if K % 128 == 0:
        return 128
    if K % 64 == 0:
        return 64
    return None


def _quantize_leaf(v: torch.Tensor, mode: str,
                   expert: Optional[bool] = None):
    """One matmul weight leaf at ``mode`` (``int8`` or ``int4``); an int4
    leaf whose contraction cannot group keeps int8. ``expert`` defaults
    to ``v.ndim >= 3`` (per-layer leaves: dense 2-D, expert stacks 3-D)."""
    if mode == "int4":
        if expert is None:
            expert = v.ndim >= 3
        group = _int4_group(v.shape[-2], expert)
        if group is not None:
            return quantize4(v, group=group)
    return quantize(v)


# The matmul weight leaves of a param tree (the reference's
# _QUANT_LEAVES): embeddings, norms and the router stay as they are.
_QUANT_LEAVES = frozenset({"wq", "wk", "wv", "wo", "wqkv", "wgu", "wgu_e",
                           "w_gate", "w_up", "w_down", "lm_head"})


def quantize_params(params: dict, mode: str = "int8") -> dict:
    """Every matmul weight leaf of a layer-stacked tree at ``mode`` (the
    reference's ``quantize_params``): stacked dense leaves are 3-D,
    expert stacks 4-D."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"mode must be int8|int4, got {mode!r}")

    def walk(d: dict) -> dict:
        return {k: (walk(v) if isinstance(v, dict)
                    else _quantize_leaf(v, mode, expert=v.ndim >= 4)
                    if k in _QUANT_LEAVES else v)
                for k, v in d.items()}
    return walk(params)


def stream_bufs(L: int, shape: tuple, mode: str, device: torch.device):
    """Empty stacked quantized buffers ``[L, *shape]`` with
    :func:`_quantize_leaf`'s precision choice for this shape; the
    layer-by-layer init loops write each layer into them."""
    K, O = shape[-2], shape[-1]
    group = _int4_group(K, len(shape) >= 3) if mode == "int4" else None
    if group is not None:
        return QTensor4(
            q=torch.empty((L, *shape[:-2], K // 2, O), dtype=torch.int8,
                          device=device),
            s=torch.empty((L, *shape[:-2], K // group, O),
                          dtype=torch.float32, device=device))
    return QTensor(q=torch.empty((L, *shape), dtype=torch.int8,
                                 device=device),
                   s=torch.empty((L, *shape[:-2], 1, O), dtype=torch.float32,
                                 device=device))


def _leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    else:
        yield params


def param_bytes(params: dict) -> int:
    """Stored bytes of a param tree (int8 leaves one byte each, packed
    int4 half a byte per logical weight, plus their scales)."""
    total = 0
    for v in _leaves(params):
        for t in (v if isinstance(v, (QTensor, QTensor4)) else (v,)):
            total += t.numel() * t.element_size()
    return total


def quant_mode(params: dict) -> str:
    """``"int4"`` if any leaf is a QTensor4, ``"int8"`` if any is a
    QTensor, else ``""`` (bf16)."""
    leaves = list(_leaves(params))
    if any(isinstance(v, QTensor4) for v in leaves):
        return "int4"
    if any(isinstance(v, QTensor) for v in leaves):
        return "int8"
    return ""
