"""Weight-only quantized matmuls: kernel A (csrc/quant_mm.cu, w8a16) and
kernel C (csrc/quant_mm4.cu, w4a16), each with its plain version.

- :func:`quant_matmul`: ``x[M, H] @ (q[H, O] int8 * s[1, O] f32)`` with an
  f32 accumulator and the per-output-channel scale applied after the dot
  — the reference's Pallas ``quant_matmul_stacked`` / ``quant_matmul``
  (p2p_llm_chat_tpu/ops/quant_mm.py).
- :func:`quant_matmul4`: ``x[M, K] @ dequant4(q[K/2, O], s[ng, O])`` with
  the split-half nibble packing of models/quant.pack4 and one f32 scale
  per (group of K/ng rows, column) — ``quant_matmul4`` /
  ``quant_matmul_stacked4``.
- :func:`quant_matmul_experts_stacked` / :func:`quant_matmul_experts_stacked4`:
  the per-expert batched forms ``x[e] @ w[layer, e]`` over a layer-stacked
  ``[L, NE, ...]`` expert pool — ``quant_matmul_experts_stacked[4]``.
  Kernel A and kernel C take the expert as a batch index.

A layer-stacked weight is read at a layer index without a slice copy (the
kernel gets pointers offset to the layer). Each wrapper launches its
kernel for CUDA tensors (or raises) and runs its ``*_reference`` only for
tensors on the CPU — there is no fallback. ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

_BK = 64          # kernel A's contraction step
_BKP = 64         # kernel C's step in packed byte rows (128 logical rows)
_BO = 128         # output-tile width of kernels A and C
_TARGET_WAVES = 2


def unpack4(p: torch.Tensor) -> torch.Tensor:
    """int8 ``[..., K/2, O]`` split-half nibbles -> int32 values in
    [-8, 7] at the logical ``[..., K, O]`` (byte row i holds row i in its
    low nibble and row i + K/2 in its high nibble, each stored +8). The
    bytes are read as uint8: torch's ``>>`` on int8 is arithmetic."""
    u = p.view(torch.uint8)
    lo = (u & 0xF).to(torch.int32) - 8
    hi = (u >> 4).to(torch.int32) - 8
    return torch.cat([lo, hi], dim=-2)


def dequant4_f32(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The f32 weight ``[..., K, O]`` of packed ``q [..., K/2, O]`` and
    group scales ``s [..., ng, O]`` (each run of K/ng rows shares one)."""
    v = unpack4(q).float()
    ng, K = s.shape[-2], v.shape[-2]
    g = v.reshape(*v.shape[:-2], ng, K // ng, v.shape[-1])
    return (g * s.float()[..., :, None, :]).reshape(v.shape)


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch: f32 product of x and the int8 weight, scaled per
    output channel, cast to x.dtype."""
    if layer is not None:
        q, s = q[layer], s[layer]
    y = (x.float() @ q.float()) * s.reshape(-1).float()
    return y.to(x.dtype)


def quant_matmul4_reference(x: torch.Tensor, q: torch.Tensor,
                            s: torch.Tensor, layer: Optional[int] = None
                            ) -> torch.Tensor:
    """Plain PyTorch: f32 product of x and the group-dequantized int4
    weight, cast to x.dtype."""
    if layer is not None:
        q, s = q[layer], s[layer]
    return (x.float() @ dequant4_f32(q, s)).to(x.dtype)


def _experts_reference(one, x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor, layer: int) -> torch.Tensor:
    """``one`` per expert (one expert's weight dequantized at a time, so
    the plain version of an [NE, 4096, 28672] pool stays small)."""
    out = torch.empty((x.shape[0], x.shape[1], q.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for e in range(x.shape[0]):
        out[e] = one(x[e], q[layer, e], s[layer, e])
    return out


def quant_matmul_experts_stacked_reference(x, q, s, layer: int):
    """Plain PyTorch: ``x[e] @ (q[layer, e] * s[layer, e])`` per expert."""
    return _experts_reference(quant_matmul_reference, x, q, s, layer)


def quant_matmul_experts_stacked4_reference(x, q, s, layer: int):
    """Plain PyTorch: ``x[e] @ dequant4(q[layer, e], s[layer, e])``."""
    return _experts_reference(quant_matmul4_reference, x, q, s, layer)


def split_plan(nkt: int, O: int, sms: int, batch: int = 1
               ) -> tuple[int, int]:
    """(splits, k-tiles per split) of the split-K over ``nkt`` contraction
    tiles: enough blocks for ~2 waves at decode shapes. Depends on the
    weight's shape, the batch (expert) count and the card only — never on
    M — so a row's result does not change with how many other rows share
    its call."""
    blocks = -(-O // _BO) * batch
    want = max(1, min(nkt, -(-_TARGET_WAVES * sms // blocks)))
    per = -(-nkt // want)
    return -(-nkt // per), per


def _bind_a(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmm_launch.restype = i
    lib.qmm_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.qmm_experts_launch.restype = i
    lib.qmm_experts_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]


def _bind_c(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmm4_launch.restype = i
    lib.qmm4_launch.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
    lib.qmm4_plan.restype = i
    lib.qmm4_plan.argtypes = [i] * 3 + [p] * 2


_sm_count: dict[int, int] = {}


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def _check_x(what: str, x: torch.Tensor, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != ndim or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous {ndim}-D bf16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _check_w(what: str, x, q, s, ndim: int) -> None:
    if (q.dtype != torch.int8 or s.dtype != torch.float32
            or q.ndim != ndim or s.ndim != ndim
            or not q.is_contiguous() or not s.is_contiguous()
            or q.device != x.device or s.device != x.device):
        raise ValueError(f"{what}: q must be contiguous int8 and s "
                         f"contiguous f32, both {ndim}-D on x's device; got "
                         f"q {q.dtype} {tuple(q.shape)}, s {s.dtype} "
                         f"{tuple(s.shape)}")


def _layer_offsets(q, s, layer: Optional[int]) -> tuple[int, int]:
    """Pointers to ``q[layer]`` / ``s[layer]`` (the bases when unstacked)."""
    if layer is None:
        return q.data_ptr(), s.data_ptr()
    if not 0 <= layer < q.shape[0]:
        raise IndexError(f"layer {layer} out of range {q.shape[0]}")
    # Contiguous: stride(0) is one layer's element count (no view made).
    return (q.data_ptr() + layer * q.stride(0),
            s.data_ptr() + layer * s.stride(0) * 4)


def _launch_a(x, q_ptr, s_ptr, out, batch, M, H, O) -> None:
    splits, per = split_plan(-(-H // _BK), O, _sms(x.device), batch)
    ws = (torch.empty((batch, splits, M, O), dtype=torch.float32,
                      device=x.device) if splits > 1 else out)
    vec = int(O % 16 == 0 and q_ptr % 16 == 0)
    lib = _build.load("quant_mm", _bind_a)
    stream = _build.stream_ptr(x.device)
    if batch == 1:
        rc = lib.qmm_launch(x.data_ptr(), q_ptr, s_ptr, out.data_ptr(),
                            ws.data_ptr(), M, H, O, splits, per, vec, stream)
    else:
        rc = lib.qmm_experts_launch(x.data_ptr(), q_ptr, s_ptr,
                                    out.data_ptr(), ws.data_ptr(), batch, M,
                                    H, O, splits, per, vec, stream)
    _build.check(rc, lib, "qmm_error_string", "kernel A")


def kernel_c_plan(M: int, K: int, ng: int) -> tuple[int, int]:
    """Kernel C's (fold segment, row tile) for an M-row call on a weight of
    contraction ``K`` in ``ng`` scale groups, as csrc/quant_mm4.cu picks
    them from the shape (``qmm4_plan``): segment 64 on the tensor cores,
    the row tile 16, 64 or 128 from M, where 64 divides both the group
    ``K / ng`` and ``K / 2``; else segment 0, the CUDA-core kernel."""
    lib = _build.load("quant_mm4", _bind_c)
    seg, bm = ctypes.c_int(), ctypes.c_int()
    rc = lib.qmm4_plan(M, K, ng, ctypes.byref(seg), ctypes.byref(bm))
    _build.check(rc, lib, "qmm4_error_string", "kernel C plan")
    return seg.value, bm.value


@functools.lru_cache(maxsize=None)
def _plan_c(K: int, O: int, ng: int, batch: int, sms: int
            ) -> tuple[int, int, int]:
    """Kernel C's (splits, 64-row tiles per split, fold segment): from the
    weight's shape, the batch and the card, never from M (the segment
    follows (K, ng) alone; M = 1 only fills the row-tile slot, which the
    launch picks itself)."""
    return (*split_plan(-(-(K // 2) // _BKP), O, sms, batch),
            kernel_c_plan(1, K, ng)[0])


def _launch_c(x, q_ptr, s_ptr, out, batch, M, K, O, ng) -> None:
    dev = x.device
    splits, per, seg = _plan_c(K, O, ng, batch, _sms(dev))
    ws = (torch.empty((batch, splits, M, O), dtype=torch.float32,
                      device=dev) if splits > 1 else out)
    vec = int(O % 16 == 0 and q_ptr % 16 == 0)
    lib = _build.load("quant_mm4", _bind_c)
    rc = lib.qmm4_launch(x.data_ptr(), q_ptr, s_ptr, out.data_ptr(),
                         ws.data_ptr(), batch, M, K, O, ng, splits, per, vec,
                         seg, _build.stream_ptr(dev))
    _build.check(rc, lib, "qmm4_error_string", "kernel C")


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 layer: Optional[int] = None) -> torch.Tensor:
    """x [M, H]; q [H, O] or layer-stacked [L, H, O] int8; s [1, O] or
    [L, 1, O] f32; ``layer`` indexes a stacked weight. Returns [M, O] in
    x.dtype (bf16 on the card)."""
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, s, layer)
    _check_x("quant_matmul", x, 2)
    _check_w("quant_matmul", x, q, s, 2 if layer is None else 3)
    M, H = x.shape
    O = q.shape[-1]
    if q.shape[-2] != H or s.shape[-2:] != (1, O):
        raise ValueError(f"quant_matmul: shape mismatch x {tuple(x.shape)} "
                         f"q {tuple(q.shape)} s {tuple(s.shape)}")
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    _launch_a(x, *_layer_offsets(q, s, layer), out, 1, M, H, O)
    quant_matmul.launches += 1
    return out


def quant_matmul4(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  layer: Optional[int] = None) -> torch.Tensor:
    """x [M, K]; q [K/2, O] or layer-stacked [L, K/2, O] int8 packed
    nibbles; s [ng, O] or [L, ng, O] f32 group scales (ng divides K);
    ``layer`` indexes a stacked weight. Returns [M, O] in x.dtype."""
    if x.device.type == "cpu":
        return quant_matmul4_reference(x, q, s, layer)
    _check_x("quant_matmul4", x, 2)
    _check_w("quant_matmul4", x, q, s, 2 if layer is None else 3)
    M, K = x.shape
    O, ng = q.shape[-1], s.shape[-2]
    if (K % 2 or q.shape[-2] != K // 2 or s.shape[-1] != O or ng < 1
            or K % ng):
        raise ValueError(f"quant_matmul4: shape mismatch x {tuple(x.shape)} "
                         f"q {tuple(q.shape)} s {tuple(s.shape)}")
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    _launch_c(x, *_layer_offsets(q, s, layer), out, 1, M, K, O, ng)
    quant_matmul4.launches += 1
    return out


def _experts_shapes(what: str, x, q, s, packed: bool):
    _check_x(what, x, 3)
    _check_w(what, x, q, s, 4)
    NE, C, K = x.shape
    O = q.shape[-1]
    rows = K // 2 if packed else K
    ok = (q.shape[1] == NE and s.shape[1] == NE and q.shape[2] == rows
          and s.shape[-1] == O and s.shape[0] == q.shape[0])
    if packed:
        ng = s.shape[2]
        ok = ok and K % 2 == 0 and ng >= 1 and K % ng == 0
    else:
        ok = ok and s.shape[2] == 1
    if not ok:
        raise ValueError(f"{what}: shape mismatch x {tuple(x.shape)} q "
                         f"{tuple(q.shape)} s {tuple(s.shape)}")
    return NE, C, K, O


def quant_matmul_experts_stacked(x: torch.Tensor, q: torch.Tensor,
                                 s: torch.Tensor, layer: int) -> torch.Tensor:
    """Per-expert w8a16: x [NE, C, H] expert buckets; q [L, NE, H, O]
    int8; s [L, NE, 1, O] f32. Returns [NE, C, O] in x.dtype."""
    if x.device.type == "cpu":
        return quant_matmul_experts_stacked_reference(x, q, s, layer)
    NE, C, H, O = _experts_shapes("quant_matmul_experts_stacked", x, q, s,
                                  packed=False)
    out = torch.empty((NE, C, O), dtype=torch.bfloat16, device=x.device)
    if C == 0 or NE == 0:
        return out
    _launch_a(x, *_layer_offsets(q, s, layer), out, NE, C, H, O)
    quant_matmul_experts_stacked.launches += 1
    return out


def quant_matmul_experts_stacked4(x: torch.Tensor, q: torch.Tensor,
                                  s: torch.Tensor, layer: int
                                  ) -> torch.Tensor:
    """Per-expert w4a16: x [NE, C, K]; q [L, NE, K/2, O] int8 packed
    nibbles; s [L, NE, ng, O] f32 group scales. Returns [NE, C, O]."""
    if x.device.type == "cpu":
        return quant_matmul_experts_stacked4_reference(x, q, s, layer)
    NE, C, K, O = _experts_shapes("quant_matmul_experts_stacked4", x, q, s,
                                  packed=True)
    out = torch.empty((NE, C, O), dtype=torch.bfloat16, device=x.device)
    if C == 0 or NE == 0:
        return out
    _launch_c(x, *_layer_offsets(q, s, layer), out, NE, C, K, O,
              s.shape[-2])
    quant_matmul_experts_stacked4.launches += 1
    return out


quant_matmul.launches = 0
quant_matmul4.launches = 0
quant_matmul_experts_stacked.launches = 0
quant_matmul_experts_stacked4.launches = 0
