"""Kernel C (csrc/quant_mm4.cu, w4a16) pinned on the CPU: what its wrapper
hands the CUDA entry point, and the arithmetic of the kernel.

1. A stand-in library records every call of ``qmm4_plan`` and
   ``qmm4_launch``. The split count, 64-row tiles per split, workspace
   shape and fold route (the segment ``qmm4_plan`` gives for (K, ng): 64
   for the tensor-core kernel, 0 for the CUDA-core one) follow the
   weight's shape (K, O, ng), the batch and the card only — never M or
   the bucket rows, so a row's result does not depend on how many rows
   share its call. An M = 0 or C = 0 call launches nothing.
2. In numpy: the nibble -> bf16 trick (``0x4300 | u`` is the bf16 128 +
   u, then one fma subtracts 136) over all 256 byte values of the B
   fragments built from an ``ldmatrix.trans`` register, against
   ``unpack4``; and a float32 emulation of each route's order — the
   tensor-core kernel's (64-row tiles per split, 16-row steps, the low
   half's sum folded with its scale before the high half's) and the
   CUDA-core kernel's (a scaled weight per element, low before high),
   each with the fixed-order split-K reduce — against the JAX package's
   ``quant_matmul4`` and
   ``quant_matmul_experts_stacked4`` (in interpret mode where their gate
   takes the shape, else the dequantize-then-matmul oracle, as
   tests/test_torch_quant4.py runs them), at odd and even group counts
   and G = 64, 128 and 256: within 1e-5 of max|ref| in float32 (the
   summation order alone differs) and within C_TOL = 1e-2 after the
   kernel's bf16 output rounding (chip_smoke's tolerance for kernel C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.ops import quant_mm as ref_qmm
from p2p_llm_chat_tpu_torch.models.configs import CONFIGS
from p2p_llm_chat_tpu_torch.models.quant import _int4_group
from p2p_llm_chat_tpu_torch.ops import _build
from p2p_llm_chat_tpu_torch.ops import quant_mm as qmm

BKP = 64            # the kernel's packed rows per tile (qmm._BKP)
C_TOL = 1e-2
F32_TOL = 1e-5
SMS = 132


def _route_seg(K: int, ng: int) -> int:
    """The fold route csrc/quant_mm4.cu's plan_of documents: 64-row
    segments on the tensor cores where 64 divides both the group and K/2,
    else 0 (the CUDA-core kernel). chip_smoke's kernel_c phase holds the
    compiled plan to it on the card."""
    return 64 if (K // ng) % BKP == 0 and (K // 2) % BKP == 0 else 0


class _Lib:
    """Records every entry-point call; ``qmm4_plan`` answers through its
    out-pointers as the kernel's plan would."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, tuple]] = []

    def qmm4_plan(self, M, K, ng, seg, bm):
        self.calls.append(("qmm4_plan", (M, K, ng)))
        seg._obj.value = _route_seg(K, ng)
        bm._obj.value = 16
        return 0

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    sizes: dict[int, tuple] = {}
    real_empty = torch.empty

    def empty(shape, *args, **kwargs):
        t = real_empty(shape, *args, **kwargs)
        sizes[t.data_ptr()] = tuple(shape)
        return t

    monkeypatch.setattr(_build, "load", lambda name, bind: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(qmm, "_sms", lambda device: SMS)
    monkeypatch.setattr(qmm.torch, "empty", empty)
    fake.sizes = sizes
    qmm._plan_c.cache_clear()
    yield fake
    qmm._plan_c.cache_clear()


def _plan_c(lib, M, K, O, ng, batch=1):
    """(splits, tiles per split, vec, seg, workspace shape) handed to
    ``qmm4_launch`` for an M-row call; every plan query is about the
    weight's (K, ng) and its segment is the one launched."""
    x = torch.zeros((batch, M, K), dtype=torch.bfloat16)
    out = torch.zeros((batch, M, O), dtype=torch.bfloat16)
    lib.calls.clear()
    qmm._launch_c(x, 4096, 8192, out, batch, M, K, O, ng)
    *plans, (name, args) = lib.calls
    for plan, (_, k, g) in plans:
        assert plan == "qmm4_plan" and (k, g) == (K, ng)
    assert name == "qmm4_launch"
    assert args[:2] == (x.data_ptr(), 4096) and args[2] == 8192
    b, m, k, o, g, splits, per, vec, seg = args[5:14]
    assert (b, m, k, o, g) == (batch, M, K, O, ng)
    assert args[14] == 0                              # the stream
    return splits, per, vec, seg, lib.sizes.get(args[4])


# (K, O, ng, segment): the int4 projections of mixtral-8x7b and
# llama3.1-8b (group 128; experts' w_down 256), mixtral-large's w_down
# (ng = 45, the high half starts mid-group), and the ragged groupings
# chip_smoke runs on each route.
_SHAPES = [(4096, 6144, 32, 64), (4096, 4096, 32, 64), (4096, 32000, 32, 64),
           (4096, 28672, 32, 64), (14336, 4096, 112, 64),
           (11520, 4096, 45, 64), (384, 136, 3, 64), (192, 200, 3, 0),
           (128, 256, 1, 64), (288, 264, 6, 0), (96, 40, 1, 0),
           (100, 130, 2, 0)]


@pytest.mark.parametrize("K,O,ng,seg", _SHAPES)
def test_kernel_c_plan_does_not_depend_on_m(lib, K, O, ng, seg):
    plans = {M: _plan_c(lib, M, K, O, ng)
             for M in (1, 8, 16, 17, 64, 65, 128, 256, 512)}
    splits, per, vec, got_seg, _ = plans[1]
    Kh = K // 2
    assert got_seg == seg == _route_seg(K, ng)
    assert (splits, per) == qmm.split_plan(-(-Kh // BKP), O, SMS)
    assert splits * per * BKP >= Kh > (splits - 1) * per * BKP
    assert vec == int(O % 16 == 0)
    for M, (s, p, v, g, ws) in plans.items():
        assert (s, p, v, g) == (splits, per, vec, seg), M
        assert ws == ((1, splits, M, O) if splits > 1 else None), M


@pytest.mark.parametrize("K,O,ng", [(4096, 28672, 32), (14336, 4096, 56),
                                    (11520, 4096, 45)])
@pytest.mark.parametrize("C", [1, 8, 17, 100, 128, 512])
def test_kernel_c_expert_grid_plan_does_not_depend_on_bucket_rows(
        lib, K, O, ng, C):
    splits, per, vec, seg, ws = _plan_c(lib, C, K, O, ng, batch=8)
    assert (splits, per) == qmm.split_plan(-(-(K // 2) // BKP), O, SMS, 8)
    assert seg == 64
    assert (splits, per, vec, seg) == _plan_c(lib, 1, K, O, ng, batch=8)[:4]
    assert ws == ((8, splits, C, O) if splits > 1 else None)


def test_every_served_int4_leaf_takes_the_tensor_core_route():
    """Each contraction the port's quantizer packs to int4 (dense and
    expert, at every registered config's widths) folds whole 64-row
    segments: the tensor-core route's condition holds (chip_smoke asks the
    compiled plan the same on the card)."""
    for name, cfg in CONFIGS.items():
        for K in {cfg.hidden_size, cfg.num_heads * cfg.head_dim,
                  cfg.intermediate_size}:
            for expert in (False, True):
                group = _int4_group(K, expert)
                if group is not None:
                    assert _route_seg(K, K // group) == 64, \
                        (name, K, expert)


def test_empty_calls_launch_nothing(lib, monkeypatch):
    """M = 0 (dense) and C = 0 or NE = 0 (expert grid) return an empty
    output without a launch; M = 1 launches once. Meta tensors stand in
    for the card's (the device check is lifted)."""
    monkeypatch.setattr(qmm, "_check_x", lambda what, x, ndim: None)
    monkeypatch.setattr(qmm.quant_matmul4, "launches", 0)
    monkeypatch.setattr(qmm.quant_matmul_experts_stacked4, "launches", 0)
    meta = torch.device("meta")
    K, O, ng, NE = 256, 384, 2, 4
    q = torch.empty((2, K // 2, O), dtype=torch.int8, device=meta)
    s = torch.empty((2, ng, O), dtype=torch.float32, device=meta)
    out = qmm.quant_matmul4(
        torch.empty((0, K), dtype=torch.bfloat16, device=meta), q, s, 1)
    assert tuple(out.shape) == (0, O) and lib.calls == []
    qe = torch.empty((2, NE, K // 2, O), dtype=torch.int8, device=meta)
    se = torch.empty((2, NE, ng, O), dtype=torch.float32, device=meta)
    out = qmm.quant_matmul_experts_stacked4(
        torch.empty((NE, 0, K), dtype=torch.bfloat16, device=meta), qe, se, 1)
    assert tuple(out.shape) == (NE, 0, O)
    out = qmm.quant_matmul_experts_stacked4(
        torch.empty((0, 5, K), dtype=torch.bfloat16, device=meta),
        qe[:, :0].contiguous(), se[:, :0].contiguous(), 1)
    assert tuple(out.shape) == (0, 5, O)
    assert lib.calls == []
    assert qmm.quant_matmul4.launches == 0
    assert qmm.quant_matmul_experts_stacked4.launches == 0
    qmm.quant_matmul4(torch.empty((1, K), dtype=torch.bfloat16, device=meta),
                      q, s, 1)
    assert [name for name, _ in lib.calls
            if name != "qmm4_plan"] == ["qmm4_launch"]
    assert qmm.quant_matmul4.launches == 1


# -- the nibble -> bf16 trick ----------------------------------------------

def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(v: np.ndarray) -> np.ndarray:
    """Round to nearest even, as fma.rn.bf16x2 rounds its result."""
    u = v.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _nib2_bf16x2(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's nib2_bf16x2: the nibbles in bits [0, 4) and [16, 20)
    of v as a bf16 pair, (low half, high half) in float32."""
    u = (v.astype(np.uint32) & 0x000F000F) | 0x43004300
    out = []
    for half in (u & 0xFFFF, u >> 16):
        a = _bf16_bits_to_f32(half)
        # fma(a, 1.0, -136.0): exact in float64, then one rounding.
        r = _f32_to_bf16_bits((a.astype(np.float64) - 136.0)
                              .astype(np.float32))
        out.append(_bf16_bits_to_f32(r))
    return out[0], out[1]


def test_nibble_to_bf16_trick_is_exact_for_every_byte():
    rng = np.random.default_rng(0)
    for pos in range(4):
        # q[k, o] for k in {2t, 2t+1}, o in {2j, 2j+1}: byte `pos` of the
        # ldmatrix.trans register runs over all 256 values, the rest
        # random.
        q = rng.integers(0, 256, size=(256, 2, 2), dtype=np.uint8)
        q[:, pos // 2, pos % 2] = np.arange(256, dtype=np.uint8)
        r = (q[:, 0, 0].astype(np.uint32) | q[:, 0, 1].astype(np.uint32) << 8
             | q[:, 1, 0].astype(np.uint32) << 16
             | q[:, 1, 1].astype(np.uint32) << 24)
        # All 256 cases side by side: packed [2, 512], column 2i + c.
        packed = q.transpose(1, 0, 2).reshape(2, 512).view(np.int8)
        want = np.asarray(ref_quant.unpack4(packed)).astype(
            np.float32).reshape(4, 256, 2).transpose(1, 0, 2)  # [256, 4, 2]
        # Even / odd columns, low / high nibbles; each pair is (k = 2t,
        # k = 2t+1) of one column.
        for shift, row0, col in ((0, 0, 0), (8, 0, 1), (4, 2, 0),
                                 (12, 2, 1)):
            lo, hi = _nib2_bf16x2(r >> shift)
            np.testing.assert_array_equal(lo, want[:, row0, col])
            np.testing.assert_array_equal(hi, want[:, row0 + 1, col])


# -- the kernel's order, emulated ---------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    return _bf16_bits_to_f32(_f32_to_bf16_bits(a))


def _emulate(x, q, s, splits, per):
    """float32 emulation of kernel C for one batch entry, on the route its
    plan takes: x [M, K] (bf16 values), q [K/2, O] int8, s [ng, O] f32;
    returns the f32 sum before the output's bf16 rounding.

    qmm4_mma_kernel: per 64-row tile, the low half's products summed in
    16-row steps, then folded with the low group's scale, then the high
    half's the same. qmm4_fma_kernel: per packed row, ascending, x times
    the weight scaled per element, low before high. Either way each
    split's partial is summed in split order (qmm4_reduce)."""
    M, K = x.shape
    Kh, O, ng = K // 2, q.shape[1], s.shape[0]
    G = K // ng
    w = np.asarray(ref_quant.unpack4(q)).astype(np.float32)   # [K, O]
    total = np.zeros((M, O), np.float32)
    for sp in range(splits):
        rows = range(sp * per * BKP, min(Kh, (sp + 1) * per * BKP))
        acc = np.zeros((M, O), np.float32)
        if _route_seg(K, ng) == 0:
            for r in rows:
                for k in (r, Kh + r):
                    ws = (w[k] * s[k // G]).astype(np.float32)
                    acc = (x[:, k:k + 1].astype(np.float64) * ws
                           + acc).astype(np.float32)
            total = (total + acc).astype(np.float32)
            continue
        for r0 in rows[::BKP]:
            for h in (0, 1):
                p = np.zeros((M, O), np.float32)
                for k16 in range(r0, r0 + BKP, 16):
                    step = np.zeros((M, O), np.float32)
                    for k in range(h * Kh + k16, h * Kh + k16 + 16):
                        step = (step + x[:, k:k + 1] * w[k:k + 1]
                                ).astype(np.float32)
                    p = (p + step).astype(np.float32)
                sc = s[(h * Kh + r0) // G].astype(np.float64)
                acc = (p.astype(np.float64) * sc + acc).astype(np.float32)
        total = (total + acc).astype(np.float32)
    return total


def _close(got: np.ndarray, want: np.ndarray, tol: float) -> None:
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


# (K, O, group): odd ng = 3 at G = 128 and 256, and at G = 64 (K/2 = 96:
# the CUDA-core route); ng = 5 at G = 128 and 256 (the high half starts
# mid-group); even ng = 4 at G = 64 and 2 at 128; G = 48 and 96,
# groupings the quantizer does not make (the CUDA-core route).
_GROUPINGS = [(192, 200, 64), (384, 136, 128), (768, 72, 256),
              (640, 72, 128), (1280, 40, 256), (256, 96, 64), (256, 264, 128),
              (288, 48, 48), (96, 40, 96)]


def _ref_dense(x, qw, rows):
    ng = qw.s.shape[-2]
    K = x.shape[1]
    if ref_qmm.pick_int4_bo(rows, K, qw.q.shape[-1], ng, 4) is not None:
        return np.asarray(ref_qmm.quant_matmul4(jnp.asarray(x), qw.q, qw.s,
                                                interpret=True))
    return x @ np.asarray(ref_quant.dequantize4(qw, jnp.float32))


@pytest.mark.parametrize("K,O,group", _GROUPINGS)
def test_fold_order_emulation_matches_jax_quant_matmul4(K, O, group):
    rng = np.random.default_rng(K + O)
    M = 5
    qw = ref_quant.quantize4(jnp.asarray(
        rng.normal(size=(K, O)).astype(np.float32)), group=group)
    x = _bf16_round(rng.normal(size=(M, K)).astype(np.float32))
    q, s = np.asarray(qw.q), np.asarray(qw.s)
    splits, per = qmm.split_plan(-(-(K // 2) // BKP), O, SMS)
    got = _emulate(x, q, s, splits, per)
    want = _ref_dense(x, qw, M).astype(np.float32)
    _close(got, want, F32_TOL)
    _close(_bf16_round(got), want, C_TOL)


@pytest.mark.parametrize("K,O,group", [(512, 128, 256), (384, 96, 128),
                                       (256, 80, 64)])
def test_fold_order_emulation_matches_jax_experts_stacked4(K, O, group):
    """ng = 1 and 3 (odd) and 4, per expert at a layer offset, with the
    plan of the whole expert batch."""
    rng = np.random.default_rng(K + group)
    L, NE, C, layer = 2, 3, 4, 1
    qw = ref_quant.quantize4(jnp.asarray(
        rng.normal(size=(L, NE, K, O)).astype(np.float32)), group=group)
    x = _bf16_round(rng.normal(size=(NE, C, K)).astype(np.float32))
    q, s = np.asarray(qw.q), np.asarray(qw.s)
    ng = s.shape[-2]
    splits, per = qmm.split_plan(-(-(K // 2) // BKP), O, SMS, NE)
    if ref_qmm.pick_int4_bo(C, K, O, ng, 4) is not None:
        want = np.asarray(ref_qmm.quant_matmul_experts_stacked4(
            jnp.asarray(x), qw.q, qw.s, layer, interpret=True))
    else:
        want = np.stack([x[e] @ np.asarray(ref_quant.dequantize4(
            ref_quant.QTensor4(qw.q[layer, e], qw.s[layer, e]), jnp.float32))
            for e in range(NE)])
    for e in range(NE):
        got = _emulate(x[e], q[layer, e], s[layer, e], splits, per)
        _close(got, want[e], F32_TOL)
        _close(_bf16_round(got), want[e], C_TOL)
