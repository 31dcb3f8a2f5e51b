"""Kernel B (csrc/paged_attention.cu) pinned on the CPU: what its wrappers
hand the CUDA entry points, and the order in which the kernel reduces a
row.

1. A stand-in library records every call of ``paged_append_launch`` and
   ``paged_pool_launch`` and reports a slice width as the source's
   ``paged_slice_tokens`` does. The slice count handed over is
   ``ceil(pages * ps / width)`` for the width the library reports (the
   source's ``SLICE``, or another): it depends on the window only, never
   on B or on the rows' lengths. The
   workspace is the wrapper's (one f32 buffer: ``[B, Hq, slices, D]``
   accumulators, then ``[B, Hq, slices, 2]`` (m, l)), so the launches stay
   capturable in a CUDA graph.
2. A float32 emulation of the kernel's per-row order: slices of ``SLICE``
   tokens at fixed absolute positions, chunks of 32 tokens (int8 pools)
   or 16 (bf16) dealt to ``NW`` warps in turn, each warp an online softmax over its chunks (scores
   times the k scales, log2 units, probabilities times the v scales
   rounded to bf16 for p.v, the unscaled ones summed for the
   denominator), the warps merged in warp order, then the live slices
   merged in slice order, seeded with the current token in append mode.
   Slots past a row's length are zero-filled, never read. Its rows are
   bitwise equal at B = 1 and B = 5 and at windows of ``pages`` and
   ``2 pages`` with NaN in every unread slot, at page sizes 16, 48 and
   64, rep 1, 3, 4 and 8 and D 32, 64 and 128; and it matches the JAX
   package's append and pool functions (their jnp gather paths) within
   5e-3 of max|ref|: the emulation rounds each probability (times its v
   scale) to bf16 for p.v, 2^-9 relative per term, where the references
   keep f32 (up to 1.7e-3 of max|ref| at these geometries).
3. Verify mode's plan, as ``verify_launch`` hands it to
   ``paged_verify_launch``: the stand-in library reports the source's
   ``verify_slice`` rule (256 tokens at S <= 64, 1024 above, read from
   the source) or another width through ``paged_verify_slice_tokens(S)``,
   and the slice count is ``ceil(pages * ps / width)`` whatever B and
   the rows' lengths; one workspace of ``[B, S, Hq, slices + 1, D]``
   accumulators (the last partial is the block's own k/v), then
   ``[.., 2]`` (m, l) — 340.8 MB at the widest llama3.1-8b call (B = 8,
   S = 512, W = 4096), 85.2 MB at draft-400m's; and calls the kernel does
   not take raise before any launch.
"""

import importlib
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu_torch.ops import _build

ref_pa = importlib.import_module("p2p_llm_chat_tpu.ops.paged_attention")
pa = importlib.import_module("p2p_llm_chat_tpu_torch.ops.paged_attention")

SLICE = 256          # tokens per block
NW = 4               # warps per block
CHUNKS = {True: 32, False: 16}   # tokens per warp step, int8 / bf16 pools
LOG2E = 1.4426950408889634

# (ps, Hq, Hkv, D, int8 pool, lengths)
GEOMETRIES = {
    "ps16_rep1_d32_int8": (16, 2, 2, 32, True, [600, 257, 16, 1, 300]),
    "ps48_rep3_d64_bf16": (48, 6, 2, 64, False, [513, 48, 2, 400, 97]),
    "ps64_rep4_d128_int8": (64, 8, 2, 128, True, [700, 64, 255, 1, 512]),
    "ps16_rep8_d32_bf16": (16, 8, 1, 32, False, [520, 33, 256, 17, 1]),
}


def test_the_emulated_constants_are_the_kernels():
    src = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    for name, value in (("SLICE", SLICE), ("NW", NW)):
        got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(got) == value, name
    got = re.search(r"constexpr int CHUNK = sizeof\(T\) == 1 \? (\d+) : "
                    r"(\d+);", src).groups()
    assert tuple(map(int, got)) == (CHUNKS[True], CHUNKS[False])
    assert "int paged_slice_tokens() { return SLICE; }" in src


def _verify_rule() -> tuple[int, int, int, int]:
    """The source's verify-mode plan: (MAX_S, S up to which slices are
    short, the short width, the long width)."""
    src = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    max_s = int(re.search(r"constexpr int MAX_S = (\d+);", src).group(1))
    longest = int(re.search(r"constexpr int VSLICE_MAX = (\d+);",
                            src).group(1))
    short_s, short = map(int, re.search(
        r"constexpr int verify_slice\(int S\) \{ return S <= (\d+) \? "
        r"(\d+) : VSLICE_MAX; \}", src).groups())
    return max_s, short_s, short, longest


class _Lib:
    """Records every entry-point call; reports ``slice_tokens`` and, for
    verify mode, the source's plan (or ``verify_width`` when set)."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, tuple]] = []
        self.slice_tokens = SLICE
        self.max_s, self.short_s, self.short, self.long = _verify_rule()
        self.verify_width = None

    def paged_slice_tokens(self) -> int:
        return self.slice_tokens

    def paged_verify_max_s(self) -> int:
        return self.max_s

    def paged_verify_slice_tokens(self, S: int) -> int:
        if self.verify_width is not None:
            return self.verify_width
        return self.short if S <= self.short_s else self.long

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    fake.allocs = []

    def recorded(alloc):
        def fn(*args, **kwargs):
            out = alloc(*args, **kwargs)
            fake.allocs.append(tuple(out.shape))
            return out
        return fn

    monkeypatch.setattr(_build, "load", lambda name, bind: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    for name in ("empty", "empty_like", "zeros"):
        monkeypatch.setattr(pa.torch, name, recorded(getattr(torch, name)))
    return fake


def _pool(B, pages, ps, Hq, Hkv, D, quantized, L=2, seed=0):
    """A pool and operands for the stand-in library (values unused)."""
    gen = torch.Generator().manual_seed(seed)
    N = 1 + B * pages
    shape = (L, N, ps, Hkv, D)
    if quantized:
        k = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        ps_pad = -(-ps // 128) * 128
        ks = torch.rand((L, N, Hkv, ps_pad), generator=gen)
        vs = torch.rand((L, N, Hkv, ps_pad), generator=gen)
    else:
        k = torch.randn(shape, generator=gen).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen).to(torch.bfloat16)
        ks = vs = None
    pt = (1 + torch.arange(B * pages, dtype=torch.int32)).reshape(B, pages)
    q = torch.randn((B, Hq, D), generator=gen).to(torch.bfloat16)
    kc = torch.randn((B, Hkv, D), generator=gen).to(torch.bfloat16)
    return k, v, ks, vs, pt, q, kc, kc.clone()


def _launch_args(lib, mode, B, pages, ps, lengths, quantized,
                 Hq=8, Hkv=2, D=64):
    k, v, ks, vs, pt, q, kc, vc = _pool(B, pages, ps, Hq, Hkv, D, quantized)
    ln = torch.tensor(lengths, dtype=torch.int32)
    lib.calls.clear()
    lib.allocs.clear()
    if mode == "append":
        out = pa._launch("append", q, kc, vc, k, v, ks, vs, pt, ln, 1, pages)
    else:
        out = pa._launch("pool", q, None, None, k, v, ks, vs, pt, ln, 1,
                         pages)
    (name, args), = lib.calls
    assert name == f"paged_{mode}_launch"
    if mode == "pool":                      # no k_cur / v_cur
        args = args[:1] + (kc.data_ptr(), vc.data_ptr()) + args[1:]
    assert args[0] == q.data_ptr() and args[3] == k.data_ptr()
    assert args[12] == out.data_ptr() and args[-1] == 0
    (B_, Hq_, Hkv_, D_, N, ps_, ps_pad, layer, pages_, splits,
     quant) = args[13:24]
    assert (B_, Hq_, Hkv_, D_, ps_, layer, pages_, quant) == (
        B, Hq, Hkv, D, ps, 1, pages, int(quantized))
    # One f32 workspace: the slices' accumulators, then their (m, l).
    assert lib.allocs == [(B * Hq * splits * (D + 2),), (B, Hq, D)]
    assert args[11] - args[10] == B * Hq * splits * D * 4
    return splits


@pytest.mark.parametrize("mode", ["append", "pool"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("width", [SLICE, 128])
def test_the_slice_count_depends_on_the_window_only(lib, mode, quantized,
                                                    width):
    lib.slice_tokens = width
    for ps in (16, 48, 64):
        for pages in (1, 5, 17):
            want = -(-pages * ps // width)
            seen = set()
            for B, lengths in ((1, [1]), (1, [pages * ps]),
                               (5, [pages * ps, 1, 33, 0, 200]),
                               (8, [7] * 8)):
                lengths = [min(n, pages * ps) for n in lengths]
                seen.add(_launch_args(lib, mode, B, pages, ps, lengths,
                                      quantized))
            assert seen == {want}, (ps, pages)


@pytest.mark.parametrize("what", ["rep16", "d48", "f32_q", "f32_pool",
                                  "scales_f16", "pages0", "layer"])
def test_unsupported_calls_raise_before_any_launch(lib, what):
    B, pages, ps, Hq, Hkv, D = 2, 3, 16, 8, 2, 64
    quantized = what == "scales_f16"
    k, v, ks, vs, pt, q, kc, vc = _pool(B, pages, ps, Hq, Hkv, D, quantized)
    layer = 1
    if what == "rep16":
        q = torch.zeros((B, 32, D), dtype=torch.bfloat16)
    elif what == "d48":
        k, v, ks, vs, pt, q, kc, vc = _pool(B, pages, ps, Hq, Hkv, 48, False)
    elif what == "f32_q":
        q = q.float()
    elif what == "f32_pool":
        k, v = k.float(), v.float()
    elif what == "scales_f16":
        ks = ks.half()
    elif what == "pages0":
        pages = 0
    else:
        layer = 2
    ln = torch.full((B,), 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa._launch("append", q, kc, vc, k, v, ks, vs, pt, ln, layer, pages)
    assert lib.calls == []


def test_the_verify_plan_is_the_kernels():
    """The widest block is the drafter's 512 (serve/draft_model.py), and
    a slice is 256 tokens up to S = 64, 1024 above: the source's rule."""
    from p2p_llm_chat_tpu_torch.serve import draft_model
    assert _verify_rule() == (512, 64, 256, 1024)
    assert draft_model._MAX_FEED == 512


def _verify_args(lib, B, S, pages, ps, lengths, quantized, tree=False,
                 Hq=8, Hkv=2, D=64):
    """The splits verify_launch hands the stand-in library, after
    checking its operands and its one workspace."""
    k, v, ks, vs, pt, _, _, _ = _pool(B, pages, ps, Hq, Hkv, D, quantized)
    gen = torch.Generator().manual_seed(S)
    q = torch.randn((B, S, Hq, D), generator=gen).to(torch.bfloat16)
    kb = torch.randn((B, S, Hkv, D), generator=gen).to(torch.bfloat16)
    mask = (torch.ones((S, S), dtype=torch.bool).tril().expand(B, S, S)
            .contiguous() if tree else None)
    ln = torch.tensor(lengths, dtype=torch.int32)
    lib.calls.clear()
    lib.allocs.clear()
    out = pa.verify_launch("verify", q, kb, kb.clone(), k, v, ks, vs, pt,
                           ln, 1, pages, mask)
    (name, args), = lib.calls
    assert name == "paged_verify_launch"
    assert args[0] == q.data_ptr() and args[4] == k.data_ptr()
    assert (args[3] is None) == (not tree)
    assert args[13] == out.data_ptr() and args[-1] == 0
    (B_, S_, Hq_, Hkv_, D_, N, ps_, ps_pad, layer, pages_, splits,
     quant) = args[14:26]
    assert (B_, S_, Hq_, Hkv_, D_, ps_, layer, pages_, quant) == (
        B, S, Hq, Hkv, D, ps, 1, pages, int(quantized))
    # One f32 workspace: every slice's accumulators and the block's, then
    # their (m, l).
    P = splits + 1
    assert lib.allocs == [(B * S * Hq * P * (D + 2),), (B, S, Hq, D)]
    assert args[12] - args[11] == B * S * Hq * P * D * 4
    assert pa.verify_plan(lib.paged_verify_slice_tokens(S), B, S, Hq, D,
                          pages * ps) == (splits, B * S * Hq * P * (D + 2))
    return splits


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("width", [None, 128], ids=["source", "w128"])
@pytest.mark.parametrize("S", [1, 8, 64, 65, 256, 512])
def test_the_verify_slice_count_depends_on_S_and_the_window_only(
        lib, quantized, width, S):
    lib.verify_width = width
    width = lib.paged_verify_slice_tokens(S)
    for ps in (16, 64):
        for pages in (1, 17, 64):
            want = -(-pages * ps // width)
            seen = set()
            for B, lengths, tree in ((1, [1], False),
                                     (1, [pages * ps], True),
                                     (3, [pages * ps, 0, 33], False)):
                lengths = [min(n, pages * ps) for n in lengths]
                seen.add(_verify_args(lib, B, S, pages, ps, lengths,
                                      quantized, tree))
            assert seen == {want}, (ps, pages)


def test_the_verify_workspace_at_the_widest_case():
    """B = 8 rows of S = 512 over W = 4096: four 1024-token window slices
    and the block's partial, for llama3.1-8b (Hq 32, D 128) and
    draft-400m (Hq 8); the plan of one row is the same at any B."""
    _, short_s, short, longest = _verify_rule()
    width = lambda S: short if S <= short_s else longest
    assert pa.verify_plan(width(512), 8, 512, 32, 128, 4096) == (
        4, 8 * 512 * 32 * 5 * 130)
    assert pa.verify_plan(width(512), 8, 512, 32, 128, 4096)[1] * 4 \
        == 340_787_200
    assert pa.verify_plan(width(512), 8, 512, 8, 128, 4096)[1] * 4 \
        == 85_196_800
    for S in (1, 8, 64, 65, 256, 512):
        for W in (64, 1000, 4096):
            one = pa.verify_plan(width(S), 1, S, 32, 128, W)
            eight = pa.verify_plan(width(S), 8, S, 32, 128, W)
            assert eight == (one[0], 8 * one[1])


@pytest.mark.parametrize("what", ["s0", "s513", "kb_shape", "rep16",
                                  "mask_shape", "mask_dtype"])
def test_unsupported_verify_calls_raise_before_any_launch(lib, what):
    B, S, pages, ps, Hq, Hkv, D = 2, 8, 3, 16, 8, 2, 64
    k, v, ks, vs, pt, _, _, _ = _pool(B, pages, ps, Hq, Hkv, D, True)
    S = {"s0": 0, "s513": 513}.get(what, S)
    q = torch.zeros((B, S, 32 if what == "rep16" else Hq, D),
                    dtype=torch.bfloat16)
    kb = torch.zeros((B, S + (what == "kb_shape"), Hkv, D),
                     dtype=torch.bfloat16)
    vb = torch.zeros((B, S, Hkv, D), dtype=torch.bfloat16)
    mask = None
    if what == "mask_shape":
        mask = torch.ones((B, S, S + 1), dtype=torch.bool)
    elif what == "mask_dtype":
        mask = torch.ones((B, S, S), dtype=torch.uint8)
    ln = torch.full((B,), 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa.verify_launch("verify", q, kb, vb, k, v, ks, vs, pt, ln, 1,
                         pages, mask)
    assert lib.calls == []


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """2^x per element, the same bits wherever the element sits: torch's
    float32 exp2 rounds differently in its vector body and its scalar
    tail, so it is taken in float64 and rounded once."""
    return torch.exp2(x.double()).float()


def emulate_kernel_b(q, kp, vp, ks, vs, pt, lengths, layer: int, pages: int,
                     kc=None, vc=None) -> torch.Tensor:
    """Kernel B's arithmetic per row, in float32: q [B, Hq, D]; pools
    [L, N, ps, Hkv, D] (int8, or float32 holding bf16 values) with scales
    [L, N, Hkv, ps_pad] on int8 pools; the current token's kc/vc
    [B, Hkv, D] in append mode. Every sum runs in a fixed order over one
    row's own values, and what the kernel never loads is zero-filled
    before any arithmetic touches it."""
    f32 = torch.float32
    chunk = CHUNKS[ks is not None]
    B, Hq, D = q.shape
    ps, Hkv = kp.shape[2], kp.shape[3]
    rep = Hq // Hkv
    W = pages * ps
    S = -(-W // SLICE)
    CPW = SLICE // (chunk * NW)
    pos = torch.arange(S * SLICE)
    lens = torch.clamp(lengths.long(), max=W)
    live = pos[None, :] < lens[:, None]                          # [B, T]
    page = torch.where(live, pt[:, torch.clamp(pos // ps, max=pages - 1)]
                       .long(), 0)
    slot = (pos % ps)[None, :].expand(B, -1)
    zero = torch.zeros((), dtype=f32)
    k = torch.where(live[..., None, None], kp[layer][page, slot].to(f32),
                    zero)                                        # [B,T,G,D]
    v = torch.where(live[..., None, None], vp[layer][page, slot].to(f32),
                    zero)
    if ks is not None:
        sk = torch.where(live[..., None], ks[layer][page, :, slot], zero)
        sv = torch.where(live[..., None], vs[layer][page, :, slot], zero)
    else:
        sk = sv = None
    scale = torch.tensor(LOG2E, dtype=f32) / torch.sqrt(
        torch.tensor(float(D), dtype=f32))
    qg = q.to(f32).reshape(B, Hkv, rep, D)
    kt = k.permute(0, 2, 1, 3)                                   # [B,G,T,D]
    s = torch.zeros((B, Hkv, rep, S * SLICE))
    for d in range(D):
        s = s + qg[..., d, None] * kt[:, :, None, :, d]
    if sk is not None:
        s = s * sk.permute(0, 2, 1)[:, :, None, :]
    s = torch.where(live[:, None, None, :], s * scale, -math.inf)
    # Position slice * SLICE + chunk (w + NW i) + t: chunk i of warp w.
    s = s.reshape(B, Hkv, rep, S, CPW, NW, chunk)
    vt = v.permute(0, 2, 1, 3).reshape(B, Hkv, S, CPW, NW, chunk, D)
    if sv is not None:
        svt = sv.permute(0, 2, 1).reshape(B, Hkv, S, CPW, NW, chunk)
    start = torch.arange(S * SLICE // chunk).reshape(S, CPW, NW) * chunk
    chunk_live = start[None] < lens[:, None, None, None]        # [B,S,CPW,NW]
    m = torch.full((B, Hkv, rep, S, NW), -math.inf)
    l = torch.zeros((B, Hkv, rep, S, NW))
    o = torch.zeros((B, Hkv, rep, S, NW, D))
    for i in range(CPW):
        x = s[:, :, :, :, i]                                     # [B,G,r,S,NW,16]
        mn = torch.maximum(m, x.amax(-1))
        al = torch.where(m == -math.inf, 0.0, _exp2(m - mn))
        p = _exp2(x - mn[..., None])
        psum = torch.zeros_like(l)
        for t in range(chunk):
            psum = psum + p[..., t]
        if sv is not None:
            p = p * svt[:, :, None, :, i]
        p = p.to(torch.bfloat16).to(f32)
        pv = torch.zeros_like(o)
        for t in range(chunk):
            pv = pv + p[..., t, None] * vt[:, :, None, :, i, :, t]
        cl = chunk_live[:, None, None, :, i]                     # [B,1,1,S,NW]
        m = torch.where(cl, mn, m)
        l = torch.where(cl, l * al + psum, l)
        o = torch.where(cl[..., None], o * al[..., None] + pv, o)
    # The block's warps, in warp order.
    mb = m.amax(-1)                                              # [B,G,r,S]
    acc = torch.zeros((B, Hkv, rep, S, D))
    lb = torch.zeros((B, Hkv, rep, S))
    for w in range(NW):
        f = _exp2(m[..., w] - mb)
        acc = acc + o[..., w, :] * f[..., None]
        lb = lb + l[..., w] * f
    # The combine: live slices in slice order, the current token first.
    slice_live = (torch.arange(S) * SLICE)[None, :] < lens[:, None]
    if kc is not None:
        x = torch.zeros((B, Hkv, rep))
        kcf = kc.to(f32)
        for d in range(D):
            x = x + qg[..., d] * kcf[:, :, None, d]
        s_cur = x * scale
        mc = s_cur
    else:
        mc = torch.full((B, Hkv, rep), -math.inf)
    for sp in range(S):
        ok = slice_live[:, None, None, sp]
        mc = torch.where(ok, torch.maximum(mc, mb[..., sp]), mc)
    if kc is not None:
        den = _exp2(s_cur - mc)
        num = den[..., None] * vc.to(f32)[:, :, None, :]
    else:
        den = torch.zeros((B, Hkv, rep))
        num = torch.zeros((B, Hkv, rep, D))
    for sp in range(S):
        ok = slice_live[:, None, None, sp]
        f = _exp2(mb[..., sp] - mc)
        den = torch.where(ok, den + lb[..., sp] * f, den)
        num = torch.where(ok[..., None], num + acc[..., sp, :] * f[..., None],
                          num)
    out = torch.where(den[..., None] > 0, num / den[..., None], zero)
    return out.reshape(B, Hq, D)


def _bf16_exact(rng, shape) -> np.ndarray:
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _inputs(geometry, seed=0):
    """numpy operands (values exact in bf16; int8 pools with f32 scales)
    and the pool's page count; row b owns pages 1 + b * pages ...; page 0
    is the garbage page."""
    ps, Hq, Hkv, D, quantized, lengths = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    B, L = len(lengths), 2
    pages = -(-max(lengths) // ps) + 1
    N = 1 + B * pages
    shape = (L, N, ps, Hkv, D)
    if quantized:
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ps_pad = -(-ps // 128) * 128
        ks = (rng.random((L, N, Hkv, ps_pad)) / 64).astype(np.float32)
        vs = (rng.random((L, N, Hkv, ps_pad)) / 64).astype(np.float32)
    else:
        k, v = _bf16_exact(rng, shape), _bf16_exact(rng, shape)
        ks = vs = None
    pt = (1 + np.arange(B * pages, dtype=np.int32)).reshape(B, pages)
    q = _bf16_exact(rng, (B, Hq, D))
    kc = _bf16_exact(rng, (B, Hkv, D))
    vc = _bf16_exact(rng, (B, Hkv, D))
    return dict(k=k, v=v, ks=ks, vs=vs, pt=pt,
                lengths=np.asarray(lengths, np.int32), q=q, kc=kc, vc=vc,
                pages=pages)


def _poisoned(x) -> dict:
    """Torch operands with NaN (int8 pools: NaN k scales, Inf v scales)
    in page 0 and in every slot of a row's own pages at or past its
    length: slots the kernel never reads."""
    t = {n: None if a is None or n == "pages" else torch.from_numpy(a.copy())
         for n, a in x.items()}
    t["pages"] = x["pages"]
    ps = x["k"].shape[2]
    dead = [(0, s) for s in range(ps)]
    for b, n in enumerate(x["lengths"]):
        dead += [(int(x["pt"][b, pos // ps]), pos % ps)
                 for pos in range(n, x["pages"] * ps)]
    for page, s in dead:
        if t["ks"] is not None:
            t["ks"][:, page, :, s] = float("nan")
            t["vs"][:, page, :, s] = float("inf")
        else:
            t["k"][:, page, s] = float("nan")
            t["v"][:, page, s] = float("nan")
    return t


def _emulate(t, mode, rows=slice(None), pages=None, layer=1):
    pt = t["pt"][rows]
    pages = t["pages"] if pages is None else pages
    if pages > pt.shape[1]:                     # extra entries -> page 0
        pt = torch.cat([pt, torch.zeros((pt.shape[0], pages - pt.shape[1]),
                                        dtype=pt.dtype)], 1)
    cur = ((t["kc"][rows], t["vc"][rows]) if mode == "append"
           else (None, None))
    return emulate_kernel_b(t["q"][rows], t["k"], t["v"], t["ks"], t["vs"],
                            pt, t["lengths"][rows], layer, pages, *cur)


def _reference(x, mode, layer=1):
    """The JAX package's function on the clean pool: the append function
    (its jnp gather path) or the pool function under impl="gather"."""
    cache = ref_kv.PagedKVCache(
        k=jnp.asarray(x["k"]), v=jnp.asarray(x["v"]),
        page_table=jnp.asarray(x["pt"]), lengths=jnp.asarray(x["lengths"]),
        k_scale=None if x["ks"] is None else jnp.asarray(x["ks"]),
        v_scale=None if x["vs"] is None else jnp.asarray(x["vs"]))
    lens = jnp.asarray(x["lengths"])
    if mode == "append":
        out = ref_pa.paged_attention_append(
            jnp.asarray(x["q"]), jnp.asarray(x["kc"]), jnp.asarray(x["vc"]),
            cache, lens, jnp.asarray(layer), pages=x["pages"],
            interpret=True)
    else:
        out = ref_pa.paged_attention(
            jnp.asarray(x["q"]), cache.k, cache.v, cache.page_table, lens,
            jnp.asarray(layer), pages=x["pages"], impl="gather",
            k_scale=cache.k_scale, v_scale=cache.v_scale)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("mode", ["append", "pool"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulation_matches_the_reference_functions(geometry, mode,
                                                   monkeypatch):
    monkeypatch.setattr(ref_pa, "_APPEND_IMPL", "gather")
    x = _inputs(geometry)
    got = _emulate(_poisoned(x), mode)
    assert bool(torch.isfinite(got).all())
    ref = _reference(x, mode)
    err = np.abs(got.numpy() - ref).max()
    assert err <= 5e-3 * np.abs(ref).max(), err


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_rows_do_not_depend_on_the_batch_or_the_window(geometry):
    """Each row of the B = 5 call equals its own B = 1 call and the call
    over twice the pages (the extra table entries point at NaN page 0)
    bit for bit, in both modes, with NaN in every unread slot."""
    t = _poisoned(_inputs(geometry, seed=1))
    for mode in ("append", "pool"):
        full = _emulate(t, mode)
        assert bool(torch.isfinite(full).all())
        assert torch.equal(_emulate(t, mode, pages=2 * t["pages"]), full)
        for b in range(full.shape[0]):
            assert torch.equal(_emulate(t, mode, rows=slice(b, b + 1)),
                               full[b:b + 1]), (mode, b)
