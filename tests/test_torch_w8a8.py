"""The w8a8 prototype of the matmul microbenchmark (kernel E's plain
version in p2p_llm_chat_tpu_torch/tools/mm_micro.py) against the
reference's ``w8a8_matmul`` in tools/mm_micro.py, on the same
numpy-seeded inputs.

The reference's Pallas kernel runs on the CPU only in interpret mode,
which its module does not ask for, so ``pl.pallas_call`` is patched to
``interpret=True`` for these tests; tools/mm_micro.py itself is
unchanged. Held:

- the per-row activation quantization (``xq`` int8 and ``xs`` f32, the
  operands the reference hands its pallas_call) bitwise, ties at .5 and
  an all-zero row included;
- the output within 1 bf16 ulp of the interpreted kernel, and in fact
  bitwise (int32 accumulation is exact on both sides, and the epilogue's
  two f32 products run in the same order): at the reference's smallest
  shape cut down in H and O, and at a ragged M and H.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from p2p_llm_chat_tpu_torch.tools import mm_micro

torch.set_num_threads(2)
pytestmark = pytest.mark.model

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref_mm():
    spec = importlib.util.spec_from_file_location(
        "_reference_mm_micro", ROOT / "tools" / "mm_micro.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpreted(monkeypatch):
    """``pl.pallas_call`` in interpret mode; the operands of every call
    are recorded (concrete when run under ``jax.disable_jit``)."""
    calls = []
    real = pl.pallas_call

    def patched(*args, **kw):
        fn = real(*args, interpret=True, **kw)

        def run(*ops):
            calls.append(ops)
            return fn(*ops)
        return run

    monkeypatch.setattr(pl, "pallas_call", patched)
    return calls


def _inputs(M, H, O, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, H)).astype(np.float32)
    x[0, :] = 0.0                           # amax 0 -> scale 1
    x[1, :3] = [127.0, 0.5, -1.5]           # q = x / 1: ties at .5
    x[1, 3:] = 0.0
    q = rng.integers(-127, 128, size=(H, O), dtype=np.int8)
    s = (rng.random((1, O)) / 64).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, q, s, torch.from_numpy(np.array(xb.astype(jnp.float32))
                                      ).to(torch.bfloat16)


def test_row_quantization_bitwise(ref_mm, interpreted):
    xb, q, s, tx = _inputs(8, 96, 512, 0)
    with jax.disable_jit():
        ref_mm.w8a8_matmul(xb, jnp.asarray(q), jnp.asarray(s))
    (ref_xq, ref_xs, _, _), = interpreted
    xq, xs = mm_micro.quantize_rows(tx)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_xq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(ref_xs))
    assert xq[1, :3].tolist() == [127, 0, -2]    # round half to even


def test_row_scale_is_the_ieee_quotient(ref_mm, interpreted):
    """The row scale is amax / 127 rounded once (IEEE f32 division, the
    reference's), not amax times a rounded 1/127: on bf16 rows whose amax
    makes the two differ, ``quantize_rows`` equals numpy's f32 quotient
    and the reference's pallas_call operands bitwise (the card's
    ``w8a8_quant_rows`` and ``quantize_rows`` are held to the same
    quotient in chip_smoke.py's kernel_e phase)."""
    rng = np.random.default_rng(18)
    cand = np.asarray(jnp.asarray((rng.random(20000) * 10.0 ** rng.integers(
        -3, 4, 20000)).astype(np.float32), jnp.bfloat16).astype(jnp.float32))
    hard = cand[cand * np.float32(1.0 / 127.0) != cand / np.float32(127.0)]
    assert hard.size > 50          # rows where a reciprocal would be off
    hard = hard[:64]
    x = rng.standard_normal((hard.size, 96)).astype(np.float32)
    x = np.clip(x * hard[:, None], -hard[:, None], hard[:, None])
    x[:, 3] = hard * np.where(np.arange(hard.size) % 2, -1.0, 1.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    assert (tx.float().abs().amax(dim=1).numpy() == hard).all()
    xq, xs = mm_micro.quantize_rows(tx)
    np.testing.assert_array_equal(xs[:, 0].numpy(), hard / np.float32(127))
    O = 128
    q = rng.integers(-127, 128, size=(96, O), dtype=np.int8)
    s = (rng.random((1, O)) / 64).astype(np.float32)
    with jax.disable_jit():
        ref_mm.w8a8_matmul(xb, jnp.asarray(q), jnp.asarray(s))
    (ref_xq, ref_xs, _, _), = interpreted
    np.testing.assert_array_equal(xs.numpy(), np.asarray(ref_xs))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_xq))


@pytest.mark.parametrize("M,H,O", [(32, 256, 512), (5, 100, 512)])
def test_output_matches_interpreted_pallas(ref_mm, interpreted, M, H, O):
    xb, q, s, tx = _inputs(M, H, O, H)
    ref = np.asarray(ref_mm.w8a8_matmul(xb, jnp.asarray(q), jnp.asarray(s)))
    assert interpreted, "the reference's pallas_call did not run"
    mm_micro.w8a8_matmul.launches = 0
    got = mm_micro.w8a8_matmul(tx, torch.from_numpy(q), torch.from_numpy(s))
    assert mm_micro.w8a8_matmul.launches == 0           # plain on CPU
    assert got.dtype == torch.bfloat16 and got.shape == (M, O)
    ulp = np.abs(got.view(torch.int16).numpy().astype(np.int32)
                 - ref.view(np.int16).astype(np.int32))
    assert ulp.max() <= 1
    assert int((ulp > 0).sum()) == 0, "expected bitwise"


def test_shape_table_and_cuda_only_kernel_wrapper(ref_mm):
    assert mm_micro.SHAPES == ref_mm.SHAPES and mm_micro.ROWS == ref_mm.ROWS
    xq = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        mm_micro.w8a8_quantized(xq, torch.ones((2, 1)),
                                torch.zeros((16, 16), dtype=torch.int8),
                                torch.ones((1, 16)))
