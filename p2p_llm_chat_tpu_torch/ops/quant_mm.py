"""w8a16 matmul: kernel A (csrc/quant_mm.cu) and its plain version.

``x[M, H] @ (q[H, O] int8 * s[1, O] f32)`` with an f32 accumulator and
the per-output-channel scale applied after the dot — the function of the
reference's Pallas ``quant_matmul_stacked`` / ``quant_matmul``
(p2p_llm_chat_tpu/ops/quant_mm.py). A layer-stacked weight ``q[L, H, O]``
is read at a layer index without a slice copy (the kernel gets pointers
offset to the layer).

:func:`quant_matmul` launches the kernel for CUDA tensors (or raises) and
runs :func:`quant_matmul_reference` only for tensors on the CPU — there
is no fallback. ``quant_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_BK = 64          # kernel A's contraction step
_BO = 128         # kernel A's output-tile width
_TARGET_WAVES = 2


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch: f32 product of x and the int8 weight, scaled per
    output channel, cast to x.dtype."""
    if layer is not None:
        q, s = q[layer], s[layer]
    y = (x.float() @ q.float()) * s.reshape(-1).float()
    return y.to(x.dtype)


def split_plan(H: int, O: int, sms: int) -> tuple[int, int]:
    """(splits, k-tiles per split) for kernel A's split-K over H: enough
    blocks for ~2 waves at decode shapes. Depends on (H, O) and the card
    only — never on M — so a row's result does not change with how many
    other rows share its call."""
    nkt = -(-H // _BK)
    blocks = -(-O // _BO)
    want = max(1, min(nkt, -(-_TARGET_WAVES * sms // blocks)))
    per = -(-nkt // want)
    return -(-nkt // per), per


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmm_launch.restype = i
    lib.qmm_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]


_sm_count: dict[int, int] = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 layer: Optional[int] = None) -> torch.Tensor:
    """x [M, H]; q [H, O] or layer-stacked [L, H, O] int8; s [1, O] or
    [L, 1, O] f32; ``layer`` indexes a stacked weight. Returns [M, O] in
    x.dtype (bf16 on the card)."""
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, s, layer)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("quant_matmul: x must be a contiguous 2-D bf16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    stacked = layer is not None
    if (q.dtype != torch.int8 or s.dtype != torch.float32
            or q.ndim != (3 if stacked else 2) or s.ndim != q.ndim
            or not q.is_contiguous() or not s.is_contiguous()
            or q.device != x.device or s.device != x.device):
        raise ValueError("quant_matmul: q must be contiguous int8 "
                         "[(L,) H, O] and s contiguous f32 [(L,) 1, O] on "
                         "x's device")
    M, H = x.shape
    O = q.shape[-1]
    if q.shape[-2] != H or s.shape[-1] != O:
        raise ValueError(f"quant_matmul: shape mismatch x {tuple(x.shape)} "
                         f"q {tuple(q.shape)} s {tuple(s.shape)}")
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    if stacked:
        if not 0 <= layer < q.shape[0]:
            raise IndexError(f"layer {layer} out of range {q.shape[0]}")
        q_ptr = q.data_ptr() + layer * H * O
        s_ptr = s.data_ptr() + layer * O * 4
    else:
        q_ptr, s_ptr = q.data_ptr(), s.data_ptr()
    splits, per = split_plan(H, O, _sms(x.device))
    ws = (torch.empty((splits, M, O), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    vec = int(O % 16 == 0 and q_ptr % 16 == 0)
    lib = _build.load("quant_mm", _bind)
    rc = lib.qmm_launch(x.data_ptr(), q_ptr, s_ptr, out.data_ptr(),
                        ws.data_ptr(), M, H, O, splits, per, vec,
                        _build.stream_ptr(x.device))
    _build.check(rc, lib, "qmm_error_string", "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
