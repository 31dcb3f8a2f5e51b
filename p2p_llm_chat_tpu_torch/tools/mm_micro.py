"""Microbenchmark: decode-shaped matmuls on the card, the twin of the
reference's tools/mm_micro.py, and kernel E's wrappers and plan.

Times one ``[ROWS, H] @ [H, O]`` product per variant and shape beside
the bytes bound of its int8 weight read:

- ``w8a16``: kernel A through ops/quant_mm.quant_matmul (the serving path);
- ``bf16``: ``torch.matmul`` on the dequantized bf16 weight;
- ``w8a8``: :func:`w8a8_matmul`, the w8a8 prototype in one C call: the
  per-row dynamic int8 quantization of x (``w8a8_quant_rows``), then
  kernel E (csrc/w8a8_mm.cu) as its programmatic dependent:
  ``int8 x int8 -> int32`` on the tensor cores and ``(acc * s) * xs`` to
  bf16;
- ``w8a8-kernel``: kernel E alone on rows already quantized (the
  reference's pallas_call);
- ``int8-lib``: ``torch._int_mm`` and the same epilogue on the same
  quantized rows, a library yardstick only (the port never calls it).

Each variant gets two columns. ``device`` is what the reference's
``timeit`` reports: it loops the op inside a scan at two lengths and
takes ``(w2 - w1) / (n2 - n1)``, which solves out the per-dispatch cost;
here ``n1`` and ``n2`` calls are captured into two CUDA graphs, each
replay is timed with CUDA events, and the same difference
(:func:`two_length_ms`) leaves neither the host's dispatch nor a graph's
launch in. ``as timed`` is CUDA events around back-to-back eager calls,
which includes the host's dispatch wherever the host is slower than the
device. Weights rotate through enough copies (three times the 50 MB L2)
that each timed call reads its weight from device memory.

    python -m p2p_llm_chat_tpu_torch.tools.mm_micro [--proj ref|llama3.1-8b|all]

``ref`` runs the reference's SHAPES (bench-1b's fused layer + lm_head),
``llama3.1-8b`` that model's five projections. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
from typing import NamedTuple, Optional

import torch

from ..models.quant import _div
from ..ops import _build
from ..ops.quant_mm import _sms

SHAPES = [  # (H, O) per bench-1b fused layer + lm_head (the reference's)
    (2048, 4096),    # wqkv
    (2048, 2048),    # wo
    (2048, 11264),   # wgu
    (5632, 2048),    # w_down
    (2048, 32768),   # lm_head
]
PROJ = [  # (H, O) of llama3.1-8b: wqkv, wo, wgu, w_down, lm_head
    (4096, 6144),
    (4096, 4096),
    (4096, 28672),
    (14336, 4096),
    (4096, 128256),
]
ROWS = 32
VARIANTS = ("w8a16", "bf16", "w8a8", "w8a8-kernel", "int8-lib")
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20

# Kernel E's geometry (csrc/w8a8_mm.cu).
BM = 32                          # rows a block, both routes
TMA_BN = TMA_BK = 128            # TMA route: [128 k, 128 n] weight tiles
RAGGED_BN, RAGGED_BK = 128, 64   # ragged route: the byte-loader kernel
STAGE_BYTES = TMA_BK * TMA_BN + BM * TMA_BK
MAX_STAGES = 3                   # the ring's deepest (the kernel's MAX_STAGES)
PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16                 # with the non-portable cluster size allowed
SMEM_PER_BLOCK = 232448          # 227 KB, an H100 block's shared memory


class W8A8Plan(NamedTuple):
    """How kernel E runs one [M, H] @ [H, O] call: the ``route`` ("tma" or
    "ragged"), a block's ``tile`` (rows, columns, k per step), the ring's
    ``stages``, ``splits`` blocks over the k tiles of each output tile,
    ``per`` k tiles each, and the thread-block ``cluster`` whose blocks
    sum one tile's splits (1: no cluster; the ragged route's splits go
    through a workspace)."""
    route: str
    tile: tuple
    stages: int
    splits: int
    per: int
    cluster: int

    @property
    def nonportable(self) -> bool:
        """A cluster above the portable 8, which the kernel allows
        (``cudaFuncAttributeNonPortableClusterSizeAllowed``)."""
        return self.cluster > PORTABLE_CLUSTER

    @property
    def ring_bytes(self) -> int:
        """Dynamic shared memory of a TMA-route block: the ring, one full /
        empty mbarrier pair a stage, 1 KB to align it to the swizzle, and
        with splits the rows it owns of each split's partial tile (int32,
        rows padded to 132 words)."""
        if self.route != "tma":
            return 0
        recv = (self.splits * -(-BM // self.splits) * (TMA_BN + 4) * 4
                if self.splits > 1 else 0)
        return 1024 + self.stages * (STAGE_BYTES + 16) + recv


def w8a8_plan(M: int, H: int, O: int, sms: int,
              aligned: bool = True) -> W8A8Plan:
    """Kernel E's plan for an [M, H] @ [H, O] call on a card of ``sms``
    SMs. The TMA route needs H % 16 == 0 and O % 16 == 0 (TMA's global
    strides are multiples of 16 bytes) and 16-byte-aligned bases
    (``aligned``); every other call takes the ragged route. The ragged
    route splits the k tiles until the blocks cover the SMs; the TMA route
    until they cover half of them (a split tile pays a cluster's
    reduction, about 1.3 us on an H100, so fewer, longer blocks win at
    the twin's shapes), at most 8 a tile (16 where even 8 would leave more
    than half the SMs idle), none empty. M is never read: a row's bits do
    not depend on who shares its call."""
    del M
    tma = aligned and H % 16 == 0 and O % 16 == 0
    bn, bk = (TMA_BN, TMA_BK) if tma else (RAGGED_BN, RAGGED_BK)
    tiles = -(-O // bn)
    nkt = -(-H // bk)
    cap = (MAX_CLUSTER if tma and 2 * tiles * PORTABLE_CLUSTER <= sms
           else PORTABLE_CLUSTER)
    cover = -(-sms // (2 * tiles)) if tma else -(-sms // tiles)
    splits = max(1, min(cap, nkt, cover))
    per = -(-nkt // splits)
    splits = -(-nkt // per)
    if not tma:
        return W8A8Plan("ragged", (BM, bn, bk), 1, splits, per, 1)
    return W8A8Plan("tma", (BM, bn, bk), min(MAX_STAGES, per), splits, per,
                    splits)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization, the reference's op
    for op: ``amax = max|x|`` per row in f32, ``xs = amax / 127`` where
    amax > 0 (else 1), ``xq = clamp(round(x / xs), -127, 127)`` (round
    half to even, as ``jnp.round``). The divisions are IEEE on every
    device (``quant._div``: a Python-scalar divisor is a multiply by its
    reciprocal on the card). Returns (xq [M, H] int8, xs [M, 1] f32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(amax > 0, _div(amax, 127.0), torch.ones_like(amax))
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def _epilogue(acc: torch.Tensor, s: torch.Tensor,
              xs: torch.Tensor) -> torch.Tensor:
    """``(acc * s) * xs`` in f32, in that order, then bf16."""
    return ((acc.float() * s.reshape(1, -1).float()) * xs).to(torch.bfloat16)


def w8a8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: x [M, H] (bf16), q [H, O] int8, s [1, O] f32 ->
    [M, O] bf16. The integer product is taken in f64, where every partial
    sum (|sum| <= 127 * 127 * H < 2^53) is exact, so it equals the int32
    accumulation of the tensor cores on any device."""
    xq, xs = quantize_rows(x)
    return _epilogue(xq.double() @ q.double(), s, xs)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w8a8_launch.restype = i
    lib.w8a8_launch.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.w8a8_tma_launch.restype = i
    lib.w8a8_tma_launch.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.w8a8_matmul_launch.restype = i
    lib.w8a8_matmul_launch.argtypes = [p] * 7 + [i] * 9 + [p]
    lib.w8a8_quant_launch.restype = i
    lib.w8a8_quant_launch.argtypes = [p] * 3 + [i] * 2 + [p]
    lib.w8a8_init.restype = i
    lib.w8a8_init.argtypes = []
    _build.check(lib.w8a8_init(), lib, "w8a8_error_string", "kernel E")


def _lib() -> ctypes.CDLL:
    return _build.load("w8a8_mm", _bind)


def _check_weight(q: torch.Tensor, s: torch.Tensor, H: int,
                  device: torch.device) -> None:
    if (q.dtype != torch.int8 or q.ndim != 2 or q.shape[0] != H
            or not q.is_contiguous() or q.device != device
            or s.dtype != torch.float32 or s.shape != (1, q.shape[1])
            or not s.is_contiguous() or s.device != device):
        raise ValueError(f"w8a8_matmul: want contiguous q int8 [{H}, O] and "
                         f"s f32 [1, O] on {device}; got q {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}, s {s.dtype} "
                         f"{tuple(s.shape)} on {s.device}")


def _workspace(plan: W8A8Plan, M: int, O: int,
               device: torch.device) -> Optional[torch.Tensor]:
    """The ragged route's int32 partial sums [splits, M, O] (the TMA route
    sums its splits inside a cluster)."""
    if plan.route != "ragged" or plan.splits == 1:
        return None
    return torch.empty((plan.splits, M, O), dtype=torch.int32, device=device)


def _launch(lib, plan: W8A8Plan, xq: torch.Tensor, xs: torch.Tensor,
            q: torch.Tensor, s: torch.Tensor, out: torch.Tensor,
            x: Optional[torch.Tensor] = None) -> int:
    """Kernel E's C entry for ``plan``: chained after the row quantization
    of ``x`` into ``xq`` / ``xs`` (``w8a8_matmul_launch``) when ``x`` is
    given, else kernel E alone on its route. Returns the CUDA error
    code."""
    M, H = xq.shape
    O = q.shape[1]
    ws = _workspace(plan, M, O, xq.device)
    ws_ptr = None if ws is None else ws.data_ptr()
    vec_a = int(H % 16 == 0 and xq.data_ptr() % 16 == 0)
    vec_b = int(O % 16 == 0 and q.data_ptr() % 16 == 0)
    ops = (xq.data_ptr(), xs.data_ptr(), q.data_ptr(), s.data_ptr(),
           out.data_ptr())
    stream = _build.stream_ptr(xq.device)
    if x is not None:
        return lib.w8a8_matmul_launch(
            x.data_ptr(), *ops, ws_ptr, M, H, O, int(plan.route == "tma"),
            plan.splits, plan.per, plan.stages, vec_a, vec_b, stream)
    if plan.route == "tma":
        return lib.w8a8_tma_launch(*ops, M, H, O, plan.splits, plan.per,
                                   plan.stages, stream)
    return lib.w8a8_launch(*ops, ws_ptr, M, H, O, plan.splits, plan.per,
                           vec_a, vec_b, stream)


def _count(route: str) -> None:
    w8a8_matmul.launches += 1
    w8a8_matmul.launches_by_route[route] += 1


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """x [M, H] bf16; q [H, O] int8; s [1, O] f32 -> [M, O] bf16. On the
    card one C call quantizes the rows (``w8a8_quant_rows``, counted in
    ``w8a8_matmul.quant_launches``) and launches kernel E after it as a
    programmatic dependent, on the route :func:`w8a8_plan` picks
    (``w8a8_matmul.launches`` and ``.launches_by_route``); on the CPU the
    plain version runs."""
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("w8a8_matmul: x must be a contiguous 2-D bf16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    M, H = x.shape
    _check_weight(q, s, H, x.device)
    O = q.shape[1]
    out = torch.empty((M, O), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    xq = torch.empty((M, H), dtype=torch.int8, device=x.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    plan = w8a8_plan(M, H, O, _sms(x.device),
                     aligned=q.data_ptr() % 16 == 0)
    lib = _lib()
    rc = _launch(lib, plan, xq, xs, q, s, out, x=x)
    _build.check(rc, lib, "w8a8_error_string", "kernel E")
    w8a8_matmul.quant_launches += 1
    _count(plan.route)
    return out


def quantize_rows_kernel(x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows` by ``w8a8_quant_rows``, the kernel that
    :func:`w8a8_matmul` launches before kernel E: (xq [M, H] int8, xs
    [M, 1] f32), bitwise the plain version's. CUDA tensors only; counted
    in ``w8a8_matmul.quant_launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_quant_rows: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError("w8a8_quant_rows: x must be a contiguous 2-D bf16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    M, H = x.shape
    xq = torch.empty((M, H), dtype=torch.int8, device=x.device)
    xs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return xq, xs
    lib = _lib()
    rc = lib.w8a8_quant_launch(x.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                               M, H, _build.stream_ptr(x.device))
    _build.check(rc, lib, "w8a8_error_string", "w8a8_quant_rows")
    w8a8_matmul.quant_launches += 1
    return xq, xs


def w8a8_quantized(xq: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """Kernel E alone, the reference's pallas_call: rows already quantized
    (xq [M, H] int8, xs [M, 1] f32; :func:`quantize_rows`), q [H, O] int8,
    s [1, O] f32 -> ``(int32 xq @ q * s) * xs`` as [M, O] bf16, on the
    route :func:`w8a8_plan` picks. CUDA tensors only; counted in
    ``w8a8_matmul.launches`` and ``.launches_by_route``."""
    if xq.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {xq.device}")
    M, H = xq.shape
    if (xq.dtype != torch.int8 or not xq.is_contiguous()
            or xs.dtype != torch.float32 or xs.shape != (M, 1)
            or not xs.is_contiguous() or xs.device != xq.device):
        raise ValueError(f"w8a8_matmul: want contiguous xq int8 [M, H] and "
                         f"xs f32 [M, 1] on one device; got xq {xq.dtype} "
                         f"{tuple(xq.shape)}, xs {xs.dtype} "
                         f"{tuple(xs.shape)}")
    _check_weight(q, s, H, xq.device)
    O = q.shape[1]
    out = torch.empty((M, O), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return out
    aligned = xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    plan = w8a8_plan(M, H, O, _sms(xq.device), aligned=aligned)
    lib = _lib()
    rc = _launch(lib, plan, xq, xs, q, s, out)
    _build.check(rc, lib, "w8a8_error_string", "kernel E")
    _count(plan.route)
    return out


w8a8_matmul.launches = 0
w8a8_matmul.launches_by_route = {"tma": 0, "ragged": 0}
w8a8_matmul.quant_launches = 0

def int8_lib(xq: torch.Tensor, xs: torch.Tensor, q: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """The library yardstick for kernel E: ``torch._int_mm`` and the same
    epilogue on rows already quantized. Timed only; never on the port's
    path."""
    return _epilogue(torch._int_mm(xq, q), s, xs)


def time_ms(fn, n: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn(i)`` over ``n`` calls back to back, CUDA
    events around the host's loop: the "as timed" column, which includes
    the host's dispatch (checks, allocations, launches) wherever the host
    is slower than the device."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def two_length_ms(t1: float, t2: float, n1: int, n2: int) -> float:
    """Time per op from two runs of ``n1`` and ``n2`` ops that took ``t1``
    and ``t2``: ``(t2 - t1) / (n2 - n1)``. A fixed cost per run (the
    reference's dispatch round trip, a graph's launch here) cancels."""
    if n2 <= n1:
        raise ValueError(f"two_length_ms: want n2 > n1, got {n1}, {n2}")
    return (t2 - t1) / (n2 - n1)


def _capture(fn, n: int) -> "torch.cuda.CUDAGraph":
    """``fn(0) .. fn(n - 1)`` captured into one CUDA graph (the first call
    runs eagerly beforehand, outside the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    return graph


def _replay_ms(graph, reps: int) -> float:
    """Least ms of one replay of ``graph`` over ``reps`` timed replays."""
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_ms(fn, n1: int, n2: int, reps: int = 5) -> float:
    """Device ms per call of ``fn(i)``, as the reference's ``timeit``
    reports it: ``n1`` and ``n2`` calls captured into two CUDA graphs,
    each replay timed with events (the best of ``reps``), and
    :func:`two_length_ms` of the two, so neither the host's dispatch nor
    a graph's launch is counted."""
    g1 = _capture(fn, n1)
    g2 = _capture(fn, n2)
    t1, t2 = _replay_ms(g1, reps), _replay_ms(g2, reps)
    del g1, g2
    return two_length_ms(t1, t2, n1, n2)


def bytes_bound_ms(H: int, O: int, rows: int = ROWS) -> float:
    """The least time of one call: its int8 weight, f32 column scales,
    bf16 input and bf16 output each moved once at the memory rate."""
    return (H * O + 4 * O + 2 * rows * (H + O)) / PEAK_BYTES_PER_S * 1e3


def weight_copies(H: int, O: int) -> int:
    """How many copies of an [H, O] int8 weight the timed calls rotate
    through: together at least three times the 50 MB L2, so that each
    call reads its weight from device memory."""
    return max(1, min(64, math.ceil(3 * L2_BYTES / (H * O))))


def run(shapes, rows: int = ROWS, iters: int = 50, seed: int = 0) -> dict:
    """Time the variants at each (H, O) in ``shapes``, on the device
    (:func:`device_ms`) and as timed (:func:`time_ms`); print one line per
    variant with both beside the bound, and the totals. Returns
    ``{(H, O): {"bound": ms, "device": {variant: ms}, "as_timed":
    {variant: ms}}}``."""
    from ..models.quant import dequantize, quantize
    from ..ops.quant_mm import quant_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}
    total = {"device": {}, "as_timed": {}, "bound": 0.0}
    for H, O in shapes:
        copies = weight_copies(H, O)
        n1 = max(4, copies)
        qts = [quantize((torch.randn((H, O), generator=gen, device=dev)
                         * H ** -0.5).to(torch.bfloat16))
               for _ in range(copies)]
        x = torch.randn((rows, H), generator=gen, device=dev).to(
            torch.bfloat16)
        xq, xs = quantize_rows(x)
        bound = bytes_bound_ms(H, O, rows)
        plan = w8a8_plan(rows, H, O, _sms(dev))
        print(f"[{rows}x{H}] @ [{H}x{O}]  (int8 weight {H * O / 1e6:.0f} MB "
              f"x {copies} copies, bound {bound * 1e3:.1f} us; kernel E "
              f"{plan.route}, {plan.splits} splits of {plan.per} k tiles, "
              f"cluster {plan.cluster}, {plan.stages} stages)", flush=True)
        wb: list = []
        fns = {
            "w8a16": lambda i: quant_matmul(
                x, qts[i % copies].q, qts[i % copies].s),
            "bf16": lambda i: torch.matmul(x, wb[i % copies]),
            "w8a8": lambda i: w8a8_matmul(
                x, qts[i % copies].q, qts[i % copies].s),
            "w8a8-kernel": lambda i: w8a8_quantized(
                xq, xs, qts[i % copies].q, qts[i % copies].s),
            "int8-lib": lambda i: int8_lib(
                xq, xs, qts[i % copies].q, qts[i % copies].s),
        }
        row = {"bound": bound, "device": {}, "as_timed": {}}
        for k in VARIANTS:
            if k == "bf16":
                wb[:] = [dequantize(qt, torch.bfloat16) for qt in qts]
            row["device"][k] = device_ms(fns[k], n1, 4 * n1)
            row["as_timed"][k] = time_ms(fns[k], iters)
            wb.clear()
            d, a = row["device"][k], row["as_timed"][k]
            print(f"  {k:11s} device {d * 1e3:9.1f} us ({bound / d:4.0%} "
                  f"of the bytes bound), as timed {a * 1e3:9.1f} us",
                  flush=True)
            for col in ("device", "as_timed"):
                total[col][k] = total[col].get(k, 0.0) + row[col][k]
        total["bound"] += bound
        out[(H, O)] = row
        del qts, fns
        torch.cuda.empty_cache()
    print(f"totals (one walk over the shapes; bound "
          f"{total['bound'] * 1e3:.1f} us):")
    for k in total["device"]:
        print(f"  {k:11s} device {total['device'][k] * 1e3:9.1f} us, as "
              f"timed {total['as_timed'][k] * 1e3:9.1f} us")
    return out


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--proj", default="ref",
                    choices=("ref", "llama3.1-8b", "all"),
                    help="shape table: the reference's SHAPES, "
                         "llama3.1-8b's projections, or both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mm_micro times the card: no CUDA device here")
    shapes = {"ref": SHAPES, "llama3.1-8b": PROJ,
              "all": SHAPES + PROJ}[args.proj]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)}; rows {ROWS}",
          flush=True)
    return run(shapes)


if __name__ == "__main__":
    main()
