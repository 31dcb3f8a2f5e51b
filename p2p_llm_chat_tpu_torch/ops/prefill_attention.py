"""Causal GQA prefill attention with a query offset: kernel D
(csrc/prefill_attention.cu) and its plain version.

Query ``i`` of a call sits at absolute position ``q_offset + i`` and sees
kv positions ``j <= q_offset + i`` (and ``j < Skv``). One function serves
every prefill attention of the port: the whole prompt (offset 0), a chunk
of a chunked prefill (offset = the chunk's first position, k/v = the
carry up to its full width) and a prefix-spliced suffix (offset = the
prefix length).

The reference picks among three implementations by size on the TPU (a
dense XLA attend, an XLA chunk-scan flash, and the Pallas library's
``flash_attention`` for causal-from-0 shapes at ``B*Hq*S^2 > 2**25`` with
``S % 512 == 0``); those thresholds are TPU artefacts. Here
:func:`prefill_attention` launches kernel D for CUDA tensors at every size
(or raises) and runs :func:`prefill_attention_reference` only for tensors
on the CPU. ``prefill_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Widest head group kernel D takes (Hq / Hkv), as kernel B.
MAX_REP = 8


def prefill_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``attend_gqa`` under
    ``causal_mask(Sq, Skv, q_offset)``. q [R, Sq, Hq, D]; k/v
    [R, Skv, Hkv, D]. Returns [R, Sq, Hq, D] in q.dtype."""
    from ..models.layers import attend_gqa, causal_mask
    mask = causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
    return attend_gqa(q, k, v, mask)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.prefill_attention_launch.restype = i
    lib.prefill_attention_launch.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.prefill_attention_plan.restype = i
    lib.prefill_attention_plan.argtypes = [i] * 5 + [p] * 2


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: int = 0) -> torch.Tensor:
    """Causal attention of q [R, Sq, Hq, D] over k/v [R, Skv, Hkv, D]
    (contiguous bf16 on the card; D in {32, 64, 128}, Hq / Hkv <= 8) with
    query ``i`` at absolute position ``q_offset + i``. Returns
    [R, Sq, Hq, D] in q.dtype."""
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    return _launch(q, k, v, q_offset)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_offset: int) -> torch.Tensor:
    """Check the operands and launch kernel D. The kernel picks its q tile
    from the geometry and the card (:func:`q_tile_plan`); its kv tiles sit
    at absolute offsets of 64, so nothing handed over here but ``Sq`` and
    ``q_offset`` differs between a chunk call and the whole prompt."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.device != q.device or t.ndim != 4
                or t.data_ptr() % 16):
            raise ValueError(f"prefill_attention: {name} must be a "
                             "contiguous 16-byte-aligned 4-D bf16 tensor on "
                             "q's device")
    R, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != R or k.shape[3] != D
            or Hq % Hkv or Hq // Hkv > MAX_REP or D not in (32, 64, 128)
            or Sq < 1 or Skv < 1 or q_offset < 0):
        raise ValueError(f"prefill_attention: unsupported geometry q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} q_offset {q_offset}")
    out = torch.empty_like(q)
    lib = _build.load("prefill_attention", _bind)
    rc = lib.prefill_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), R, Sq,
        Skv, Hq, Hkv, D, int(q_offset), _build.stream_ptr(q.device))
    _build.check(rc, lib, "prefill_attention_error_string",
                 "prefill_attention")
    prefill_attention.launches += 1
    return out


def q_tile_plan(R: int, Sq: int, Hq: int, Hkv: int, D: int
                ) -> tuple[int, int]:
    """The q tile kernel D runs a call of this geometry with on the current
    card: (warps per head QW, the block's dynamic shared memory in bytes).
    A block holds 16 QW query positions of every head of one kv-head group
    on (Hq / Hkv) QW warps. Launches nothing."""
    lib = _build.load("prefill_attention", _bind)
    qw, smem = ctypes.c_int(), ctypes.c_int()
    rc = lib.prefill_attention_plan(R, Sq, Hq, Hkv, D, ctypes.byref(qw),
                                    ctypes.byref(smem))
    _build.check(rc, lib, "prefill_attention_error_string",
                 "prefill_attention_plan")
    return qw.value, smem.value


prefill_attention.launches = 0
