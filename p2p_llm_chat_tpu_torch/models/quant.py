"""Weight-only int8 (w8a16) quantization — the port of the int8 half of
p2p_llm_chat_tpu/models/quant.py.

Storage is the reference's: ``QTensor(q: int8[..., in, out], s: f32[...,
1, out])``, symmetric per-output-channel scales over the contraction axis.
Decode is bandwidth-bound, so decode-shaped calls (<= 512 rows) run
kernel A (ops/quant_mm.py), which reads the int8 bytes only; prefill-
shaped calls dequantize the weight once and run a plain matmul, as the
reference's ``_deq_once`` + XLA do. A layer index takes the place of the
reference's ``LayerSlice``: a stacked ``[L, in, out]`` weight is read at
that layer without a slice copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.quant_mm import quant_matmul

# Row threshold for kernel A: decode ticks and short-prompt prefill sit at
# or below it; longer prefill dequantizes once and runs a plain matmul.
_KERNEL_MAX_ROWS = 512


class QTensor(NamedTuple):
    """int8 weight + f32 per-output-channel scale (contraction axis kept
    as size-1 so ``q * s`` broadcasts)."""

    q: torch.Tensor
    s: torch.Tensor


def quantize(w: torch.Tensor, axis: int = -2) -> QTensor:
    """Symmetric int8 quantization with per-channel scales over ``axis``
    (the matmul contraction axis). The f32 op order of the reference, so
    bytes and scales match it exactly."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def dequantize(w: QTensor, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    return (w.q.float() * w.s).to(dtype)


def mm(x: torch.Tensor, w, layer: Optional[int] = None) -> torch.Tensor:
    """``x @ w`` (``x @ w[layer]`` for a layer-stacked weight) for a plain
    tensor or a :class:`QTensor`."""
    if not isinstance(w, QTensor):
        return x @ (w if layer is None else w[layer])
    lead, H = x.shape[:-1], x.shape[-1]
    rows = x.numel() // H if H else 0
    O = w.q.shape[-1]
    if rows <= _KERNEL_MAX_ROWS:
        y = quant_matmul(x.reshape(rows, H).contiguous(), w.q, w.s, layer)
        return y.reshape(*lead, O)
    q, s = (w.q, w.s) if layer is None else (w.q[layer], w.s[layer])
    return x @ dequantize(QTensor(q, s), x.dtype)


def param_bytes(params: dict) -> int:
    """Stored bytes of a param tree (int8 leaves count one byte each)."""
    def walk(v) -> int:
        if isinstance(v, dict):
            return sum(walk(x) for x in v.values())
        if isinstance(v, QTensor):
            return walk(v.q) + walk(v.s)
        return v.numel() * v.element_size()
    return walk(params)


def quant_mode(params: dict) -> str:
    """``"int8"`` when any leaf is a QTensor, else ``""`` (bf16)."""
    def walk(v) -> bool:
        if isinstance(v, dict):
            return any(walk(x) for x in v.values())
        return isinstance(v, QTensor)
    return "int8" if walk(params) else ""
