"""Kernel E (csrc/w8a8_mm.cu, w8a8) pinned on the CPU: its plan, what its
wrapper hands the CUDA entry points, and the twin's timing arithmetic.

1. ``mm_micro.w8a8_plan`` at the twin's ten shapes (the reference's
   SHAPES and llama3.1-8b's projections), at TMA-route edges (H and O
   off the 128-wide tiles, a cluster of 16) and at ragged shapes: the TMA
   route exactly where H % 16 == 0, O % 16 == 0 and the bases are 16-byte
   aligned; every k tile of every output tile in exactly one split, no
   split empty; clusters of at most 8, or of up to 16 only where the plan
   says they are non-portable; the ring within an H100 block's 227 KB;
   the same plan for M = 1, 32 and 37 (a row's bits never depend on who
   shares its call).
2. A stand-in library records what ``mm_micro._launch`` hands each entry
   point (``w8a8_matmul_launch``, ``w8a8_tma_launch``, ``w8a8_launch``):
   the plan's route, splits, k tiles and stages, a workspace only on the
   ragged route with splits, never both of the ragged kernel's vector
   flags (that shape is the TMA route's), the same arguments at every M.
3. The two-length arithmetic of the twin's device time (the reference's
   ``timeit``): ``(t2 - t1) / (n2 - n1)`` cancels any fixed cost per run,
   and ``device_ms`` captures two graph lengths and applies it.
4. The wrappers on the CPU: ``w8a8_matmul`` runs its plain version (no
   launch counted); kernel E alone and the quantization kernel refuse a
   CPU tensor (no plain fallback behind a kernel's name).
"""

import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu_torch.ops import _build
from p2p_llm_chat_tpu_torch.tools import mm_micro

SMS = 132
TWIN = mm_micro.SHAPES + mm_micro.PROJ
EDGES = [(2064, 4096), (2048, 4112), (8192, 256), (64, 16), (16, 16),
         (4096, 128256 + 16)]
RAGGED = [(100, 200), (4100, 1000), (2048, 136), (2056, 4096), (2048, 4100)]
ALL = TWIN + EDGES + RAGGED


def _tma_expected(H, O, aligned=True):
    return aligned and H % 16 == 0 and O % 16 == 0


@pytest.mark.parametrize("H,O", ALL)
@pytest.mark.parametrize("aligned", [True, False])
def test_route_follows_shape_and_alignment(H, O, aligned):
    plan = mm_micro.w8a8_plan(32, H, O, SMS, aligned=aligned)
    want = "tma" if _tma_expected(H, O, aligned) else "ragged"
    assert plan.route == want
    if want == "tma":
        assert plan.tile == (32, mm_micro.TMA_BN, mm_micro.TMA_BK)
        assert plan.cluster == plan.splits
    else:
        assert plan.tile == (32, mm_micro.RAGGED_BN, mm_micro.RAGGED_BK)
        assert plan.cluster == 1 and plan.ring_bytes == 0


def test_twin_shapes_take_the_tma_route_and_ragged_ones_do_not():
    assert all(mm_micro.w8a8_plan(32, H, O, SMS).route == "tma"
               for H, O in TWIN + EDGES)
    assert all(mm_micro.w8a8_plan(32, H, O, SMS).route == "ragged"
               for H, O in RAGGED)


@pytest.mark.parametrize("H,O", ALL)
def test_every_k_tile_of_every_output_tile_covered_once(H, O):
    plan = mm_micro.w8a8_plan(32, H, O, SMS)
    _, bn, bk = plan.tile
    nkt = -(-H // bk)
    owners = np.zeros(nkt, dtype=np.int64)
    for sp in range(plan.splits):
        lo, hi = sp * plan.per, min(nkt, (sp + 1) * plan.per)
        assert hi > lo, f"split {sp} is empty"
        owners[lo:hi] += 1
    assert (owners == 1).all()
    # Output tiles are independent of the split: each of the
    # ceil(O / bn) tiles runs the same splits.
    assert plan.splits * -(-O // bn) >= 1


@pytest.mark.parametrize("H,O", ALL)
def test_cluster_size_and_ring_bytes(H, O):
    plan = mm_micro.w8a8_plan(32, H, O, SMS)
    assert 1 <= plan.cluster <= mm_micro.MAX_CLUSTER
    assert plan.cluster <= mm_micro.PORTABLE_CLUSTER or plan.nonportable
    assert plan.nonportable == (plan.cluster > mm_micro.PORTABLE_CLUSTER)
    assert plan.ring_bytes <= mm_micro.SMEM_PER_BLOCK
    if plan.route == "tma":
        assert 1 <= plan.stages <= min(mm_micro.MAX_STAGES, plan.per)


def test_a_narrow_deep_weight_takes_a_non_portable_cluster():
    plan = mm_micro.w8a8_plan(32, 8192, 256, SMS)
    assert plan.route == "tma" and plan.cluster == 16 and plan.nonportable
    wide = mm_micro.w8a8_plan(32, 4096, 4096, SMS)
    assert not wide.nonportable


@pytest.mark.parametrize("H,O", ALL)
def test_plan_does_not_depend_on_m(H, O):
    plans = {M: mm_micro.w8a8_plan(M, H, O, SMS) for M in (1, 32, 37)}
    assert plans[1] == plans[32] == plans[37]


class _Lib:
    """Records every entry-point call."""

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

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(mm_micro.torch, "empty", empty)
    fake.sizes = sizes
    return fake


def _operands(M, H, O):
    x = torch.zeros((M, H), dtype=torch.bfloat16)
    xq = torch.zeros((M, H), dtype=torch.int8)
    xs = torch.ones((M, 1), dtype=torch.float32)
    q = torch.zeros((H, O), dtype=torch.int8)
    s = torch.ones((1, O), dtype=torch.float32)
    out = torch.zeros((M, O), dtype=torch.bfloat16)
    return x, xq, xs, q, s, out


@pytest.mark.parametrize("H,O", TWIN[:2] + EDGES[:3] + RAGGED[:3])
@pytest.mark.parametrize("chained", [True, False])
def test_launch_arguments_follow_the_plan(lib, H, O, chained):
    seen = {}
    for M in (1, 32, 37):
        x, xq, xs, q, s, out = _operands(M, H, O)
        aligned = xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
        plan = mm_micro.w8a8_plan(M, H, O, SMS, aligned=aligned)
        lib.calls.clear()
        rc = mm_micro._launch(lib, plan, xq, xs, q, s, out,
                              x=x if chained else None)
        assert rc == 0
        (name, args), = lib.calls
        ops = (xq.data_ptr(), xs.data_ptr(), q.data_ptr(), s.data_ptr(),
               out.data_ptr())
        if chained:
            assert name == "w8a8_matmul_launch"
            assert args[0] == x.data_ptr() and args[1:6] == ops
            ws = args[6]
            m, h, o, route, splits, per, stages, vec_a, vec_b = args[7:16]
            assert route == int(plan.route == "tma")
            assert len(args) == 17 and args[-1] == 0  # the stream
        elif plan.route == "tma":
            assert name == "w8a8_tma_launch" and args[:5] == ops
            ws = None
            m, h, o, splits, per, stages = args[5:11]
            assert len(args) == 12 and args[-1] == 0  # the stream
        else:
            assert name == "w8a8_launch" and args[:5] == ops
            ws = args[5]
            m, h, o, splits, per, vec_a, vec_b = args[6:13]
            stages = plan.stages
        if plan.route == "ragged":
            assert not (vec_a and vec_b)
        assert (m, h, o) == (M, H, O)
        assert (splits, per, stages) == (plan.splits, plan.per, plan.stages)
        if plan.route == "ragged" and plan.splits > 1:
            assert lib.sizes[ws] == (plan.splits, M, O)
        else:
            assert ws is None
        seen[M] = (name, splits, per, stages)
    assert seen[1] == seen[32] == seen[37]


def test_two_length_arithmetic_cancels_a_fixed_cost():
    fixed, per_op = 0.375, 0.0625          # exact in binary
    t = {n: fixed + n * per_op for n in (8, 32)}
    assert mm_micro.two_length_ms(t[8], t[32], 8, 32) == per_op
    assert mm_micro.two_length_ms(1.0, 4.0, 10, 40) == 0.1
    with pytest.raises(ValueError):
        mm_micro.two_length_ms(1.0, 2.0, 8, 8)


def test_device_ms_replays_two_graph_lengths(monkeypatch):
    captured = []

    class _Graph:
        def __init__(self, n):
            self.n = n

    def capture(fn, n):
        captured.append(n)
        for i in range(n):
            fn(i)
        return _Graph(n)

    monkeypatch.setattr(mm_micro, "_capture", capture)
    monkeypatch.setattr(mm_micro, "_replay_ms",
                        lambda g, reps: 0.5 + 0.25 * g.n)
    calls = []
    got = mm_micro.device_ms(calls.append, 4, 16)
    assert captured == [4, 16] and calls == list(range(4)) + list(range(16))
    assert got == 0.25


def test_weight_copies_exceed_the_l2():
    for H, O in TWIN:
        n = mm_micro.weight_copies(H, O)
        assert n >= 1
        assert n * H * O >= 3 * mm_micro.L2_BYTES or n == 64


def test_cpu_paths_plain_and_kernels_refuse_cpu_tensors():
    mm_micro.w8a8_matmul.launches = 0
    before = dict(mm_micro.w8a8_matmul.launches_by_route)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).to(
        torch.bfloat16)
    q = torch.from_numpy(rng.integers(-127, 128, (32, 16), dtype=np.int8))
    s = torch.from_numpy((rng.random((1, 16)) / 64).astype(np.float32))
    got = mm_micro.w8a8_matmul(x, q, s)
    assert torch.equal(got, mm_micro.w8a8_matmul_reference(x, q, s))
    assert mm_micro.w8a8_matmul.launches == 0
    assert mm_micro.w8a8_matmul.launches_by_route == before
    xq, xs = mm_micro.quantize_rows(x)
    with pytest.raises(ValueError, match="unsupported device"):
        mm_micro.w8a8_quantized(xq, xs, q, s)
    with pytest.raises(ValueError, match="unsupported device"):
        mm_micro.quantize_rows_kernel(x)
