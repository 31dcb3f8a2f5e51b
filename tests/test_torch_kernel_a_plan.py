"""What the wrappers of kernels A and C hand their CUDA entry points, pinned
on the CPU with a stand-in library that records each call.

Kernel A's K order and split plan must not depend on M (a row's result
must not change with how many rows share its call): the split count,
K tiles per split and the workspace shape per row follow the weight's
shape, the batch and the card only. Kernel C's launch arguments are those
of its own plan (64 packed rows per tile, a fold segment of (K, ng)).
"""

import pytest
import torch

from p2p_llm_chat_tpu_torch.ops import _build
from p2p_llm_chat_tpu_torch.ops import quant_mm as qmm


class _Lib:
    """Records every entry-point call (and the workspace it was given)."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, tuple]] = []

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
    monkeypatch.setattr(qmm, "_sms", lambda device: 132)
    monkeypatch.setattr(qmm.torch, "empty", empty)
    fake.sizes = sizes
    return fake


def _plan_a(lib, M, H, O, batch=1):
    x = torch.zeros((batch, M, H), dtype=torch.bfloat16)
    out = torch.zeros((batch, M, O), dtype=torch.bfloat16)
    lib.calls.clear()
    qmm._launch_a(x, 4096, 8192, out, batch, M, H, O)
    (name, args), = lib.calls
    if batch == 1:
        assert name == "qmm_launch"
        ws, m, h, o, splits, per, vec = args[4:11]
    else:
        assert name == "qmm_experts_launch"
        ws, b, m, h, o, splits, per, vec = args[4:12]
        assert b == batch
    assert (m, h, o) == (M, H, O)
    ws_shape = lib.sizes.get(ws)
    return splits, per, vec, ws_shape


_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
           (4096, 128256), (100, 200), (128, 256)]


@pytest.mark.parametrize("H,O", _SHAPES)
def test_kernel_a_split_plan_does_not_depend_on_m(lib, H, O):
    plans = {M: _plan_a(lib, M, H, O) for M in (1, 8, 16, 17, 64, 256, 512)}
    splits, per, vec, _ = plans[1]
    assert splits * per * qmm._BK >= H > (splits - 1) * per * qmm._BK
    assert (splits, per) == qmm.split_plan(-(-H // 64), O, 132)
    for M, (s, p, v, ws) in plans.items():
        assert (s, p, v) == (splits, per, vec), M
        assert ws == ((1, splits, M, O) if splits > 1 else None), M


@pytest.mark.parametrize("C", [1, 8, 17, 128, 512])
def test_kernel_a_expert_grid_plan_does_not_depend_on_bucket_rows(lib, C):
    splits, per, vec, ws = _plan_a(lib, C, 4096, 28672, batch=8)
    assert (splits, per) == qmm.split_plan(64, 28672, 132, 8)
    assert (splits, per, vec) == _plan_a(lib, 1, 4096, 28672, batch=8)[:3]
    assert ws == ((8, splits, C, 28672) if splits > 1 else None)


def test_kernel_a_k_step_and_kernel_c_plan_are_unchanged(lib, monkeypatch):
    """Kernel A's 64-wide K step, and kernel C's plan: 64 packed rows per
    tile (128 logical rows) and the fold segment its kernel's plan gives
    for mixtral-8x7b's wqkv, the same at every M
    (tests/test_torch_kernel_c_plan.py pins the rest of kernel C's
    plan)."""
    assert (qmm._BK, qmm._BKP, qmm._BO) == (64, 64, 128)
    K, O, ng = 4096, 6144, 32
    monkeypatch.setattr(qmm, "kernel_c_plan",
                        lambda M, k, g: (64 if (k, g) == (K, ng) else 0, 16))
    qmm._plan_c.cache_clear()
    for M in (1, 8, 256):
        x = torch.zeros((M, K), dtype=torch.bfloat16)
        out = torch.zeros((M, O), dtype=torch.bfloat16)
        lib.calls.clear()
        qmm._launch_c(x, 4096, 8192, out, 1, M, K, O, ng)
        (name, args), = lib.calls
        assert name == "qmm4_launch"
        splits, per = qmm.split_plan(-(-(K // 2) // 64), O, 132, 1)
        assert args[5:14] == (1, M, K, O, ng, splits, per, 1, 64)
    qmm._plan_c.cache_clear()
