"""Kernels A and C against their plain versions and the library, with
timing rows: the twin of the reference's tools/check_quant_kernel.py.

For each shape of the reference's matrix, the serving configs' decode
projections (hidden 1024, 2048 and 4096 at each config's fused output
widths: :data:`DENSE`; the MoE expert pools: :data:`EXPERTS`), at the
reference's rows (``ROWS = 32`` decode rows, ``EXPERT_ROWS = 16`` a
bucket of ``NE = 8`` experts) on a layer-stacked random weight:

- w8a16 (kernel A, ops/quant_mm.quant_matmul) and w4a16 (kernel C,
  quant_matmul4), stacked at the first and last layer and unstacked, and
  the expert forms (quant_matmul_experts_stacked[4]; int4 experts at the
  grouping quantize-time picks, group 256 and an odd group count at
  H = 11520), each held against its plain version and against
  ``torch.matmul`` on the dequantized bf16 weight (the library), relative
  error under 2e-2 of the largest output, the reference's tolerance;
- then the kernel's and the library's device time per call
  (card.step_ms: CUDA graphs at two lengths), the stack's layers rotating
  so each call reads its weight from device memory (a stack holds at
  least three times the 50 MB L2), beside the bytes bound. A shape where
  the kernel loses to the library (slower by over 2%, the reference's
  margin) is printed as such; it does not fail the run.

    python -m p2p_llm_chat_tpu_torch.tools.check_quant_kernel [--dense ref|none|HxO,...] [--experts ref|none|HxO,...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from ..models.quant import QTensor, QTensor4, _int4_group, dequantize
from ..models.quant import dequantize4, quantize, quantize4
from ..ops.quant_mm import (quant_matmul, quant_matmul4,
                            quant_matmul4_reference,
                            quant_matmul_experts_stacked,
                            quant_matmul_experts_stacked4,
                            quant_matmul_experts_stacked4_reference,
                            quant_matmul_experts_stacked_reference,
                            quant_matmul_reference)
from .card import Rows, add_device_arg, bound_ms, resolve, step_ms
from .mm_micro import L2_BYTES

ROWS = 32           # serving decode batch
EXPERT_ROWS = 16    # per-expert capacity bucket at decode (B=32, top-2/8)
NE = 8
TOL = 2e-2          # of max|reference|, the reference's
LOSS_MARGIN = 1.02  # the reference's: a kernel slower than this loses
# (H, O): draft-400m's H=1024 trunk (wqkv-fused 2048, the 4096 MLP),
# bench-1b's H=2048, llama3.1-8b's H=4096 with the fused gate|up width.
DENSE = ((1024, 2048), (1024, 4096), (2048, 2048), (2048, 11264),
         (4096, 4096), (4096, 28672))
# MoE expert pools: bench-moe's fused wgu_e and w_down, then
# mixtral-large's expert scale (int4 group 256 at H = 11520: 45 groups).
EXPERTS = ((1024, 5632), (2816, 1024), (4096, 23040), (11520, 4096))


def _layers(nbytes_layer: int) -> int:
    """Layers of a stack: at least the reference's 2, and enough that
    together they hold three times the L2."""
    return max(2, min(64, math.ceil(3 * L2_BYTES / nbytes_layer)))


def _stack(L: int, lead: tuple, H: int, O: int, mode: str,
           group: Optional[int], gen, dev):
    """A random [L, *lead, H, O] weight quantized one matrix at a time (the
    f32 temporaries stay one matrix big): (q, s)."""
    q = s = None
    for idx in range(L * max(1, math.prod(lead))):
        w = torch.randn((H, O), generator=gen, device=dev) * H ** -0.5
        qt = quantize(w) if mode == "int8" else quantize4(w, group=group)
        if q is None:
            q = torch.empty((L, *lead, *qt.q.shape), dtype=qt.q.dtype,
                            device=dev)
            s = torch.empty((L, *lead, *qt.s.shape), dtype=qt.s.dtype,
                            device=dev)
        q.view(-1, *qt.q.shape)[idx] = qt.q
        s.view(-1, *qt.s.shape)[idx] = qt.s
    return q, s


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    g, r = got.float(), ref.float()
    return float((g - r).abs().max() / (r.abs().max().clamp_min(1e-30)))


def check(mode: str, H: int, O: int, experts: bool, dev: torch.device,
          show=print) -> dict:
    """One shape: parity rows, then the timing row. Returns its readings
    (``kernel_ms``, ``library_ms``, ``bound_ms``, ``loses``, the errors);
    raises AssertionError past the tolerance."""
    gen = torch.Generator(device=dev).manual_seed(H + O)
    group = None
    if mode == "int4":
        group = _int4_group(H, experts)
        assert group is not None, f"int4 must serve H={H}"
    per_byte = 1.0 if mode == "int8" else 0.5
    lead = (NE,) if experts else ()
    rows = EXPERT_ROWS if experts else ROWS
    L = _layers(int(H * O * per_byte * (NE if experts else 1)))
    q, s = _stack(L, lead, H, O, mode, group, gen, dev)
    x = (torch.randn((*lead, rows, H), generator=gen, device=dev)
         .to(torch.bfloat16))
    if experts:
        kern = (quant_matmul_experts_stacked if mode == "int8"
                else quant_matmul_experts_stacked4)
        plain = (quant_matmul_experts_stacked_reference if mode == "int8"
                 else quant_matmul_experts_stacked4_reference)
    else:
        kern = quant_matmul if mode == "int8" else quant_matmul4
        plain = (quant_matmul_reference if mode == "int8"
                 else quant_matmul4_reference)

    def deq(layer: int) -> torch.Tensor:
        qt = (QTensor(q[layer], s[layer]) if mode == "int8"
              else QTensor4(q[layer], s[layer]))
        return (dequantize(qt, torch.bfloat16) if mode == "int8"
                else dequantize4(qt, torch.bfloat16))

    kind = f"{mode} {'experts' if experts else 'dense'} H={H} O={O}"
    if mode == "int4":
        kind += f" ng={s.shape[-2]}"
    errs = []
    for layer in (0, L - 1):
        got = kern(x, q, s, layer)
        e_plain = _rel(got, plain(x, q, s, layer))
        e_lib = _rel(got, torch.matmul(x, deq(layer)))
        errs.append((e_plain, e_lib))
        show(f"{kind} layer={layer}: rel err {e_plain:.5f} vs the plain "
             f"version, {e_lib:.5f} vs torch.matmul on the dequantized "
             "weight")
        assert e_plain < TOL and e_lib < TOL, f"{kind} diverges"
    if not experts:
        got = kern(x, q[0], s[0])
        assert _rel(got, plain(x, q[0], s[0])) < TOL, \
            f"{kind} unstacked diverges"
    lib_w = torch.stack([deq(i) for i in range(L)])
    k_ms = step_ms(lambda i: kern(x, q, s, i % L), dev, 2 * L, 6 * L)
    l_ms = step_ms(lambda i: torch.matmul(x, lib_w[i % L]), dev, 2 * L,
                   6 * L)
    del lib_w
    n_mat = NE if experts else 1
    nbytes = (n_mat * (H * O * per_byte + s[0].numel() / n_mat * 4)
              + 2 * n_mat * rows * (H + O))
    b_ms, _ = bound_ms(nbytes, 2.0 * n_mat * rows * H * O)
    loses = k_ms > l_ms * LOSS_MARGIN
    show(f"{kind} ({rows} rows{f' x {NE} experts' if experts else ''}, "
         f"{L} layers rotating): kernel {k_ms:.4f} ms vs library "
         f"{l_ms:.4f} ms ({l_ms / k_ms:.2f}x), H100 bytes bound "
         f"{b_ms:.4f} ms ({b_ms / k_ms:.0%} of it)"
         + ("; the kernel LOSES to the library at this shape" if loses
            else ""))
    return dict(shape=kind, kernel_ms=k_ms, library_ms=l_ms, bound_ms=b_ms,
                loses=loses, errors=errs)


def _shapes(arg: str, ref: tuple) -> tuple:
    if arg == "ref":
        return ref
    if arg == "none":
        return ()
    return tuple(tuple(int(v) for v in p.split("x")) for p in arg.split(","))


def main(argv: Optional[list[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", default="ref",
                    help="'ref' (the reference's matrix), 'none' or HxO,...")
    ap.add_argument("--experts", default="ref",
                    help="'ref' (the reference's pools), 'none' or HxO,...")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    show = Rows(dev)
    out = []
    for H, O in _shapes(args.dense, DENSE):
        for mode in ("int8", "int4"):
            out.append(check(mode, H, O, False, dev, show))
    for H, O in _shapes(args.experts, EXPERTS):
        for mode in ("int8", "int4"):
            out.append(check(mode, H, O, True, dev, show))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    lost = [r["shape"] for r in out if r["loses"]]
    show(f"quant kernel parity OK over {len(out)} shapes; the kernel loses "
         f"to the library at {len(lost)}: {', '.join(lost) or 'none'}")
    return out


if __name__ == "__main__":
    main()
