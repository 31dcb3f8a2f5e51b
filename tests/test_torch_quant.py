"""int8 weight quantization and the w8a16 matmul of the port, held against
the reference on the same numpy-seeded inputs.

- ``quantize`` bytes and scales must be BITWISE equal (same f32 op order,
  round half to even on both sides).
- kernel A's plain version (``quant_matmul_reference`` — what the wrapper
  runs for CPU tensors) against the reference's Pallas kernels in
  interpret mode: f32 inputs agree to ~1e-5 of the output scale (only the
  f32 summation order differs); bf16 inputs to 2e-2 (one bf16 rounding of
  the output, 2^-8 relative, either side of a tie).
- ``mm`` on more than 512 rows (dequantize once, then a plain matmul)
  against the reference's ``mm``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.ops.quant_mm import (quant_matmul as ref_qmm,
                                           quant_matmul_stacked as ref_qmm_st)
from p2p_llm_chat_tpu_torch.models.convert import tensor_from_numpy
from p2p_llm_chat_tpu_torch.models.quant import QTensor, mm, quantize
from p2p_llm_chat_tpu_torch.ops.quant_mm import (quant_matmul,
                                                 quant_matmul_reference)

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), device="cpu")


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bitwise(dtype):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 96, 80)).astype(np.float32)
    w[:, :, 5] = 0.0                        # amax == 0 -> scale 1
    # Exact halves at scale 1 (amax 127): the round-half-to-even ties.
    w[0, :6, 7] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    w[0, 6:, 7] = 0.0
    wj = jnp.asarray(w, getattr(jnp, dtype))
    ref = ref_quant.quantize(wj)
    got = quantize(_t(wj))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 5, 8])
def test_qmm_reference_matches_pallas_stacked(rows, dtype):
    rng = np.random.default_rng(rows)
    L, H, O = 3, 256, 384
    qw = ref_quant.quantize(jnp.asarray(rng.normal(size=(L, H, O)),
                                        jnp.float32))
    x = jnp.asarray(rng.normal(size=(rows, H)), getattr(jnp, dtype))
    want = ref_qmm_st(x, qw.q, qw.s, jnp.asarray(1), interpret=True)
    got = quant_matmul_reference(_t(x), _t(qw.q), _t(qw.s), layer=1)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmm_reference_matches_pallas_2d(dtype):
    rng = np.random.default_rng(7)
    H, O = 256, 384
    qw = ref_quant.quantize(jnp.asarray(rng.normal(size=(H, O)),
                                        jnp.float32))
    x = jnp.asarray(rng.normal(size=(8, H)), getattr(jnp, dtype))
    want = ref_qmm(x, qw.q, qw.s, interpret=True)
    got = quant_matmul_reference(_t(x), _t(qw.q), _t(qw.s))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("rows,stacked", [(8, False), (8, True),
                                          (600, False), (600, True)])
def test_mm_matches_reference_mm(rows, stacked):
    """Both sides of the 512-row rule: kernel-shaped calls (plain version
    on the CPU) and dequantize-once calls, 2-D and layer-stacked."""
    rng = np.random.default_rng(rows)
    H, O = 128, 256
    shape = (2, H, O) if stacked else (H, O)
    qw = ref_quant.quantize(jnp.asarray(rng.normal(size=shape), jnp.float32))
    x = jnp.asarray(rng.normal(size=(rows, H)), jnp.float32)
    w_ref = ref_quant.LayerSlice(qw, jnp.asarray(1)) if stacked else qw
    want = ref_quant.mm(x, w_ref)
    qt = QTensor(_t(qw.q), _t(qw.s))
    got = mm(_t(x), qt, 1 if stacked else None)
    assert tuple(got.shape) == (rows, O)
    _close(got, want, TOL["float32"])


def test_quant_matmul_takes_plain_path_on_cpu():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, size=(2, 64, 48),
                                      dtype=np.int8))
    s = torch.from_numpy(rng.random((2, 1, 48), dtype=np.float32))
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    before = quant_matmul.launches
    got = quant_matmul(x, q, s, layer=1)
    assert quant_matmul.launches == before
    want = (x.double() @ q[1].double()) * s[1].double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
