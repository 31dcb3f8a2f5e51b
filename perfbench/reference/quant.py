"""Frozen arithmetic of the weight and KV quantization the configurations
state, worked out again from the bf16 weights (plain PyTorch, f32).

- int8 weights: one scale per output column over the contraction axis,
  ``s = amax / 127`` (1 where the column is zero), ``q = round(w / s)``
  clipped to [-127, 127], rounding half to even;
- int4 weights: one scale per (group of rows, column), ``s = amax / 7``,
  ``q`` clipped to [-7, 7]; groups of 256 rows for an expert matrix whose
  contraction is at least 8192 and divisible by 256, else 128, else 64;
- int8 KV: one scale per (token, kv head) over the head's width.

Each function returns the dequantized f32 tensor the matmul sees.
"""

from __future__ import annotations

import torch


def _quotient(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as an IEEE quotient (a tensor divisor: a scalar one may be
    taken as a multiplication by its reciprocal)."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, _quotient(amax, 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(wf / s), -127, 127) * s


def int4_group(K: int, expert: bool) -> int | None:
    if K % 2:
        return None
    if expert and K >= 8192 and K % 256 == 0:
        return 256
    for g in (128, 64):
        if K % g == 0:
            return g
    return None


def int4_weight(w: torch.Tensor, expert: bool) -> torch.Tensor:
    group = int4_group(w.shape[-2], expert)
    if group is None:
        return int8_weight(w)
    wf = w.float()
    K, O = wf.shape[-2:]
    g = wf.reshape(*wf.shape[:-2], K // group, group, O)
    amax = g.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, _quotient(amax, 7.0), torch.ones_like(amax))
    return (torch.clamp(torch.round(g / s), -7, 7) * s).reshape(wf.shape)


def weight(w: torch.Tensor, mode: str, expert: bool = False) -> torch.Tensor:
    """The f32 weight a matmul at ``mode`` (``int8``, ``int4`` or ``""``
    for bf16) computes with."""
    if mode == "int8":
        return int8_weight(w)
    if mode == "int4":
        return int4_weight(w, expert)
    if mode == "":
        return w.float()
    raise ValueError(f"unknown weight quantization {mode!r}")


def int8_kv(x: torch.Tensor) -> torch.Tensor:
    """k or v ``[..., D]`` through the int8 pool and back."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, _quotient(amax, 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(x / s), -127, 127) * s


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """The control's activations: each row scaled to e4m3's range by its
    abs-max and rounded to float8_e4m3fn, then back to f32."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).float() * s
