"""Kernel D (csrc/prefill_attention.cu) pinned on the CPU: what its wrapper
hands the CUDA entry point, and the order in which the kernel reduces a row.

1. A stand-in library records every call of ``prefill_attention_launch``.
   The wrapper hands over shapes, ``q_offset`` and pointers only: no
   workspace and no segmentation of the kv walk. The kernel walks kv in
   tiles of ``BKV`` positions at absolute offsets from position 0 (a
   compile-time constant of the source) and picks its q tile itself, so a
   chunk call and the whole-prompt call differ only in ``Sq``,
   ``q_offset`` and the q pointer.
2. A float32 emulation of the kernel's per-row order: each block holds a
   q tile of ``bq`` positions (16 per warp, every head of a group), walks
   the 64-wide kv tiles up to its last position with an online softmax
   (running max, sum and unnormalised accumulator, probabilities rounded
   to v's dtype for p.v), a warp skips a tile wholly past its rows, and kv
   slots past the block's last position are zero-filled, never read. Its
   rows are bitwise equal between chunk calls, prefix-suffix calls and
   the whole-prompt call, whatever q tile the plan picks (16, 32, 64, 128
   positions), with NaN in every unread slot; and it matches the JAX
   package's ``attend_gqa_auto`` within 1e-5 of max|ref| (f32 summation
   order; the emulation divides by the sum at the end).
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import layers as ref_layers
from p2p_llm_chat_tpu_torch.ops import _build
from p2p_llm_chat_tpu_torch.ops import prefill_attention as pa

BKV = 64                        # the kernel's kv tile
Q_TILES = (16, 32, 64, 128)     # 16 QW positions, QW in 1, 2, 4, 8

# (R, Sq, Skv, q_offset, Hq, Hkv, D): rep 1, 3 and 4; D 32 and 64.
GEOMETRIES = {
    "rep1_d32_whole": (2, 80, 80, 0, 2, 2, 32),
    "rep3_d64_offset": (1, 37, 120, 70, 6, 2, 64),
    "rep4_d32_offset": (2, 70, 100, 13, 8, 2, 32),
}


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


def _bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16)


def _launch_args(lib, q, k, v, off):
    lib.calls.clear()
    lib.allocs.clear()
    before = pa.prefill_attention.launches
    out = pa._launch(q, k, v, off)
    # The output is the only allocation: no workspace, no split.
    (name, args), = lib.calls
    assert name == "prefill_attention_launch"
    assert pa.prefill_attention.launches == before + 1
    assert lib.allocs == [tuple(q.shape)]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[-1] == 0                             # the stream
    return args[4:-1]


@pytest.mark.parametrize("R,S,C,P,Hq,Hkv,D", [
    (1, 2048, 256, 88, 32, 8, 128),      # llama3.1-8b / mixtral-8x7b
    (3, 200, 64, 37, 12, 4, 64),
    (2, 90, 16, 5, 4, 4, 32),
])
def test_chunk_calls_differ_from_the_whole_prompt_only_in_sq_and_offset(
        lib, R, S, C, P, Hq, Hkv, D):
    q = _bf16((R, S, Hq, D), 0)
    k = _bf16((R, S, Hkv, D), 1)
    v = _bf16((R, S, Hkv, D), 2)
    whole = _launch_args(lib, q, k, v, 0)
    assert whole == (R, S, S, Hq, Hkv, D, 0)
    for off in range(0, S, C):
        qc = q[:, off:off + C].contiguous()
        assert _launch_args(lib, qc, k, v, off) == (
            R, qc.shape[1], S, Hq, Hkv, D, off)
    qs = q[:, P:].contiguous()
    assert _launch_args(lib, qs, k, v, P) == (R, S - P, S, Hq, Hkv, D, P)


@pytest.mark.parametrize("what", ["rep16", "d48", "offset", "f32", "kv_len",
                                  "misaligned"])
def test_unsupported_calls_raise_before_any_launch(lib, what):
    R, S, Hq, Hkv, D, off = 1, 32, 8, 2, 64, 0
    q, k, v = (_bf16((R, S, h, D), i) for i, h in enumerate((Hq, Hkv, Hkv)))
    if what == "rep16":
        q, k, v = _bf16((R, S, 16, D), 0), k[:, :, :1].contiguous(), \
            v[:, :, :1].contiguous()
    elif what == "d48":
        q, k, v = (_bf16((R, S, h, 48), i)
                   for i, h in enumerate((Hq, Hkv, Hkv)))
    elif what == "offset":
        off = -1
    elif what == "f32":
        q = q.float()
    elif what == "kv_len":
        v = v[:, :-1].contiguous()
    else:
        q = _bf16((R * S * Hq * D + 1,), 0)[1:].view(R, S, Hq, D)
    with pytest.raises(ValueError):
        pa._launch(q, k, v, off)
    assert lib.calls == []


def test_the_emulated_tile_is_the_kernels():
    src = (_build.CSRC_DIR / "prefill_attention.cu").read_text()
    assert re.search(r"constexpr int BKV = (\d+);", src).group(1) == str(BKV)
    assert re.search(r"constexpr int MAX_WARPS = (\d+);", src).group(1) \
        == str(max(Q_TILES) // 16)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """2^x per element, the same bits wherever the element sits: torch's
    float32 exp2 rounds differently in its vector body and its scalar
    tail, so it is taken in float64 and rounded once."""
    return torch.exp2(x.double()).float()


def emulate_kernel_d(q, k, v, q_offset: int, bq: int) -> torch.Tensor:
    """Kernel D's arithmetic per row, in float32: q [R, Sq, Hq, D], k/v
    [R, Skv, Hkv, D], query i at absolute position ``q_offset + i``, q
    tiles of ``bq`` positions (a multiple of 16). Every sum runs in a fixed
    order over one row's own values, as the kernel's dot products and
    per-column reductions do."""
    R, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    f32 = torch.float32
    scale = torch.tensor(1.4426950408889634, dtype=f32) / torch.sqrt(
        torch.tensor(float(D), dtype=f32))
    i = torch.arange(Sq)
    pos = q_offset + i
    # Per row: its block's kv_end and its warp's last position.
    kv_end = torch.clamp(q_offset + torch.clamp((i // bq + 1) * bq, max=Sq),
                         max=Skv)
    warp_last = q_offset + torch.clamp(i // 16 * 16 + 15, max=Sq - 1)
    ntiles = -(-int(kv_end.max()) // BKV)
    # Slots past every block's kv_end are zero-filled, never read (the
    # rows of an earlier block mask their own tail to p = 0 exactly).
    j = torch.arange(Skv)
    read = (j < int(kv_end.max()))[None, :, None, None]
    kz = torch.where(read, k.to(f32), 0.0).repeat_interleave(rep, 2)
    vz = torch.where(read, v.to(f32), 0.0).repeat_interleave(rep, 2)
    pad = ntiles * BKV - Skv
    if pad > 0:
        kz = torch.nn.functional.pad(kz, (0, 0, 0, 0, 0, pad))
        vz = torch.nn.functional.pad(vz, (0, 0, 0, 0, 0, pad))
    qh = q.to(f32).permute(0, 2, 1, 3)               # [R, Hq, Sq, D]
    kh = kz.permute(0, 2, 1, 3)                      # [R, Hq, T, D]
    vh = vz.permute(0, 2, 1, 3)
    m = torch.full((R, Hq, Sq), -math.inf)
    lsum = torch.zeros((R, Hq, Sq))
    acc = torch.zeros((R, Hq, Sq, D))
    for t in range(ntiles):
        j0 = t * BKV
        walked = (j0 < kv_end) & (j0 <= warp_last)   # [Sq]
        if not bool(walked.any()):
            continue
        kt = kh[:, :, j0:j0 + BKV]                   # [R, Hq, 64, D]
        vt = vh[:, :, j0:j0 + BKV]
        s = torch.zeros((R, Hq, Sq, BKV))
        for d in range(D):
            s = s + qh[..., d, None] * kt[:, :, None, :, d]
        jj = j0 + torch.arange(BKV)
        vis = (jj[None, :] <= pos[:, None]) & (jj[None, :] < kv_end[:, None])
        s = torch.where(vis, s * scale, -math.inf)
        mn = torch.maximum(m, s.amax(-1))
        sh = torch.where(mn == -math.inf, 0.0, mn)
        al = torch.where(m == -math.inf, 0.0, _exp2(m - mn))
        p = _exp2(s - sh[..., None])
        psum = torch.zeros_like(lsum)
        for c in range(BKV):
            psum = psum + p[..., c]
        pr = p.to(v.dtype).to(f32)
        pv = torch.zeros_like(acc)
        for c in range(BKV):
            pv = pv + pr[..., c, None] * vt[:, :, None, c]
        w = walked[None, None, :]
        m = torch.where(w, mn, m)
        lsum = torch.where(w, lsum * al + psum, lsum)
        acc = torch.where(w[..., None], acc * al[..., None] + pv, acc)
    out = acc * (1.0 / lsum)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _inputs(geometry, seed=0):
    R, Sq, Skv, off, Hq, Hkv, D = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(R, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(R, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(R, Skv, Hkv, D)).astype(np.float32)
    return q, k, v, off


def _poisoned(x: np.ndarray, start: int) -> torch.Tensor:
    """x with NaN in every kv slot from ``start`` on (never to be read)."""
    t = torch.from_numpy(x.copy())
    t[:, start:] = float("nan")
    return t


@pytest.mark.parametrize("bq", Q_TILES)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulation_matches_the_reference_attend_gqa_auto(geometry, bq):
    q, k, v, off = _inputs(geometry)
    Sq, Skv = q.shape[1], k.shape[1]
    mask = ref_layers.causal_mask(Sq, Skv, off)
    ref = np.asarray(ref_layers.attend_gqa_auto(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))
    got = emulate_kernel_d(torch.from_numpy(q), _poisoned(k, off + Sq),
                           _poisoned(v, off + Sq), off, bq)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_rows_do_not_depend_on_the_call(geometry):
    """The rows of chunk calls (NaN past each chunk), of a prefix-suffix
    call and of every q tile equal the whole prompt's bit for bit."""
    q, k, v, _ = _inputs(geometry, seed=1)
    R, L, Hq, D = q.shape
    kf, vf = torch.from_numpy(k), torch.from_numpy(v)
    qf = torch.from_numpy(q)
    whole = emulate_kernel_d(qf, _poisoned(k, L), _poisoned(v, L), 0, 16)
    assert bool(torch.isfinite(whole).all())
    for bq in Q_TILES[1:]:
        assert torch.equal(emulate_kernel_d(qf, kf, vf, 0, bq), whole), bq
    C = 32
    for off in range(0, L, C):
        end = min(off + C, L)
        for bq in (16, 64):
            part = emulate_kernel_d(qf[:, off:end].contiguous(),
                                    _poisoned(k, end), _poisoned(v, end),
                                    off, bq)
            assert torch.equal(part, whole[:, off:end]), (off, bq)
    P = L // 3 + 5
    suffix = emulate_kernel_d(qf[:, P:].contiguous(), kf, vf, P, 32)
    assert torch.equal(suffix, whole[:, P:])


def test_a_wholly_masked_tile_leaves_a_row_unchanged():
    """The property the warp skip rests on. In a call at offset 61, rows
    61-63 share a warp with rows 64-76, so they walk kv tile 1 (positions
    64-127), wholly masked for them; in the whole-prompt call their warp
    (rows 48-63) skips that tile. The bits are the same."""
    q, k, v, _ = _inputs("rep1_d32_whole", seed=2)
    qf, kf, vf = (torch.from_numpy(x) for x in (q, k, v))
    whole = emulate_kernel_d(qf, kf, vf, 0, 16)
    part = emulate_kernel_d(qf[:, 61:77].contiguous(), kf, vf, 61, 16)
    assert torch.equal(part, whole[:, 61:77])


def test_emulation_rounds_the_probabilities_to_bf16_like_the_plain_version():
    q, k, v, off = _inputs("rep4_d32_offset", seed=3)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = emulate_kernel_d(qb, kb, vb, off, 32).float()
    ref = pa.prefill_attention_reference(qb, kb, vb, off).float()
    # The plain version normalises before rounding p, the kernel after.
    assert (got - ref).abs().max() <= 1e-2 * ref.abs().max()
