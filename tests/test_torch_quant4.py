"""int4 weight quantization, kernel C's plain version and the expert
matmuls of the port, held against the reference on the same numpy-seeded
inputs.

- ``pack4`` / ``unpack4`` / ``quantize4`` bytes and scales must be BITWISE
  equal (same f32 op order, round half to even on both sides), at groups
  64 / 128 / 256 with even and odd group counts; ``dequantize4`` equal.
- the plain ``quant_matmul4`` (what the wrapper runs for CPU tensors),
  2-D and at a layer offset, against the reference's Pallas
  ``quant_matmul4`` / ``quant_matmul_stacked4`` in interpret mode where
  its coverage gate accepts the shape, and against the dequantize-then-
  matmul oracle where it does not; f32 inputs agree to 1e-5 of the output
  scale (only the f32 summation order differs), bf16 inputs to 2e-2 (one
  bf16 rounding of the output, 2^-8 relative, either side of a tie).
- the plain expert versions against ``quant_matmul_experts_stacked[4]``
  in interpret mode, including the odd ng = 1 half-group walk.
- ``mm`` / ``q_einsum`` on both sides of the 512-row rule against the
  reference's, and ``params_from_numpy`` on an int4 tree whose ng = 1
  leaves have int8-shaped scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.ops import quant_mm as ref_qmm
from p2p_llm_chat_tpu_torch.models import quant
from p2p_llm_chat_tpu_torch.models.convert import (params_from_numpy,
                                                   tensor_from_numpy)
from p2p_llm_chat_tpu_torch.models.quant import QTensor, QTensor4
from p2p_llm_chat_tpu_torch.ops import quant_mm

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), device="cpu")


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _q4(ref: "ref_quant.QTensor4") -> QTensor4:
    return QTensor4(_t(ref.q), _t(ref.s))


@pytest.mark.parametrize("K,group", [(192, 64), (256, 64), (384, 128),
                                     (512, 128), (768, 256), (512, 256),
                                     (128, 128)])
def test_quantize4_pack_unpack_bitwise(K, group):
    """ng = K / group: 3 (odd), 4, 3, 4, 3, 2 and 1 (odd)."""
    rng = np.random.default_rng(K + group)
    w = rng.normal(size=(2, K, 80)).astype(np.float32)
    w[:, :, 5] = 0.0                        # amax == 0 -> scale 1
    # Exact halves at scale 1 (group amax 7): round-half-to-even ties.
    w[0, :group, 7] = 0.0
    w[0, :6, 7] = [7.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    ref = ref_quant.quantize4(jnp.asarray(w), group=group)
    got = quant.quantize4(torch.from_numpy(w), group=group)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))
    assert got.shape == (2, K, 80) and got.group == group
    # unpack4 / pack4 on their own, over every byte value.
    v = rng.integers(-8, 8, size=(K, 80)).astype(np.int32)
    np.testing.assert_array_equal(
        quant.pack4(torch.from_numpy(v)).numpy(),
        np.asarray(ref_quant.pack4(jnp.asarray(v))))
    packed = np.asarray(ref.q)
    np.testing.assert_array_equal(quant.unpack4(_t(packed)).numpy(),
                                  np.asarray(ref_quant.unpack4(packed)))
    every = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    np.testing.assert_array_equal(quant.unpack4(_t(every)).numpy(),
                                  np.asarray(ref_quant.unpack4(every)))
    # dequantize4 in f32: the same products, so equal.
    np.testing.assert_array_equal(
        quant.dequantize4(got, torch.float32).numpy(),
        np.asarray(ref_quant.dequantize4(ref, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,stacked", [(1, False), (5, True), (8, False),
                                          (8, True)])
def test_qmm4_reference_matches_pallas(rows, stacked, dtype):
    rng = np.random.default_rng(rows + 10 * stacked)
    L, K, O, group = 3, 512, 256, 128
    shape = (L, K, O) if stacked else (K, O)
    qw = ref_quant.quantize4(jnp.asarray(rng.normal(size=shape),
                                         jnp.float32), group=group)
    assert ref_qmm.pick_int4_bo(rows, K, O, K // group, 4) is not None
    x = jnp.asarray(rng.normal(size=(rows, K)), getattr(jnp, dtype))
    if stacked:
        want = ref_qmm.quant_matmul_stacked4(x, qw.q, qw.s, jnp.asarray(1),
                                             interpret=True)
        got = quant_mm.quant_matmul4(_t(x), _t(qw.q), _t(qw.s), layer=1)
    else:
        want = ref_qmm.quant_matmul4(x, qw.q, qw.s, interpret=True)
        got = quant_mm.quant_matmul4(_t(x), _t(qw.q), _t(qw.s))
    assert tuple(got.shape) == (rows, O)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("K,group,stacked", [(192, 64, False),
                                             (128, 128, True),
                                             (384, 128, True)])
def test_qmm4_reference_matches_dequant_oracle(K, group, stacked):
    """Groupings the Pallas gate refuses (G = 64; odd ng at G = 128 —
    tiny's ng = 1 trunk): the reference serves them by dequantizing, and
    kernel C serves them too."""
    rng = np.random.default_rng(K)
    O = 200
    ng = K // group
    assert ref_qmm.pick_int4_bo(5, K, O, ng, 4) is None
    shape = (2, K, O) if stacked else (K, O)
    qw = ref_quant.quantize4(jnp.asarray(rng.normal(size=shape),
                                         jnp.float32), group=group)
    x = jnp.asarray(rng.normal(size=(5, K)), jnp.float32)
    w = (ref_quant.QTensor4(qw.q[1], qw.s[1]) if stacked else qw)
    want = x @ ref_quant.dequantize4(w, jnp.float32)
    got = quant_mm.quant_matmul4(_t(x), _t(qw.q), _t(qw.s),
                                 layer=1 if stacked else None)
    _close(got, want, TOL["float32"])


def test_experts_int8_reference_matches_pallas():
    L, NE, C, H, F = 2, 2, 5, 256, 256
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, size=(L, NE, H, F), dtype=np.int8)
    s = rng.random((L, NE, 1, F), np.float32) * 0.02 + 0.005
    x = rng.standard_normal((NE, C, H)).astype(np.float32)
    for layer in range(L):
        want = ref_qmm.quant_matmul_experts_stacked(
            jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), layer,
            interpret=True)
        got = quant_mm.quant_matmul_experts_stacked(_t(x), _t(q), _t(s),
                                                    layer)
        assert tuple(got.shape) == (NE, C, F)
        _close(got, want, TOL["float32"])


@pytest.mark.parametrize("group", [512, 256, 128])
def test_experts_int4_reference_matches_pallas(group):
    """ng = 1 (odd: the half-group walk), 2 and 4."""
    L, NE, C, H, F = 2, 2, 5, 512, 256
    rng = np.random.default_rng(group)
    qt = ref_quant.quantize4(jnp.asarray(
        rng.standard_normal((L, NE, H, F)).astype(np.float32)), group=group)
    x = rng.standard_normal((NE, C, H)).astype(np.float32)
    for layer in range(L):
        want = ref_qmm.quant_matmul_experts_stacked4(
            jnp.asarray(x), qt.q, qt.s, layer, interpret=True)
        got = quant_mm.quant_matmul_experts_stacked4(_t(x), _t(qt.q),
                                                     _t(qt.s), layer)
        _close(got, want, TOL["float32"])


@pytest.mark.parametrize("rows,stacked", [(8, False), (8, True),
                                          (600, False), (600, True)])
def test_mm_int4_matches_reference_mm(rows, stacked):
    """Both sides of the 512-row rule: kernel-shaped calls (plain version
    on the CPU) and dequantize-once calls, 2-D and layer-stacked."""
    rng = np.random.default_rng(rows + stacked)
    K, O = 256, 192
    shape = (2, K, O) if stacked else (K, O)
    qw = ref_quant.quantize4(jnp.asarray(rng.normal(size=shape),
                                         jnp.float32))
    x = jnp.asarray(rng.normal(size=(rows, K)), jnp.float32)
    w_ref = ref_quant.LayerSlice(qw, jnp.asarray(1)) if stacked else qw
    want = ref_quant.mm(x, w_ref)
    got = quant.mm(_t(x), _q4(qw), 1 if stacked else None)
    assert tuple(got.shape) == (rows, O)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("spec,C", [("ech,ehf->ecf", 8),
                                    ("ecf,efh->ech", 8),
                                    ("ech,ehf->ecf", 520)])
def test_q_einsum_matches_reference(spec, C, bits):
    """Expert buckets of <= 512 rows take the expert kernels' plain
    versions; 520 rows (and the reference everywhere off the TPU) take
    the dequantize-and-einsum path."""
    rng = np.random.default_rng(C + bits)
    L, NE, K, O = 2, 3, 128, 96
    w = jnp.asarray(rng.normal(size=(L, NE, K, O)), jnp.float32)
    qw = (ref_quant.quantize(w) if bits == 8
          else ref_quant.quantize4(w, group=64))
    x = jnp.asarray(rng.normal(size=(NE, C, K)), jnp.float32)
    want = ref_quant.q_einsum(spec, x, ref_quant.LayerSlice(qw, 1))
    qt = (QTensor if bits == 8 else QTensor4)(_t(qw.q), _t(qw.s))
    got = quant.q_einsum(spec, _t(x), qt, 1)
    assert tuple(got.shape) == (NE, C, O)
    _close(got, want, TOL["float32"])


def test_params_from_numpy_keeps_int4_leaves_apart():
    """tiny's int4 trunk groups at 128 over K = 128, so most leaves have
    one scale group: ``s [..., 1, O]``, the shape of an int8 scale. The
    leaf's type decides, not its shapes."""
    cfg = ref_config("tiny")
    params = quote_params(cfg, jax.random.PRNGKey(2), quantized=True,
                          quant="int4")
    tree = jax.tree.map(np.asarray, params)
    got = params_from_numpy(tree, device="cpu")
    for name, leaf in tree["layers"].items():
        if isinstance(leaf, ref_quant.QTensor4):
            assert isinstance(got["layers"][name], QTensor4), name
            np.testing.assert_array_equal(got["layers"][name].q.numpy(),
                                          leaf.q)
    assert got["layers"]["wqkv"].s.shape[-2] == 1        # the ng = 1 case
    assert isinstance(got["lm_head"], QTensor4)
    assert quant.quant_mode(got) == ref_quant.quant_mode(params) == "int4"
    assert quant.param_bytes(got) == ref_quant.param_bytes(params)


def test_int4_group_rule_matches_reference():
    for K in (63, 64, 96, 128, 4096, 8192, 11520, 14336, 192, 320):
        for expert in (False, True):
            assert quant._int4_group(K, expert) == \
                ref_quant._int4_group(K, expert), (K, expert)


def test_int4_wrappers_take_plain_path_on_cpu():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-128, 128, size=(2, 3, 32, 48),
                                      dtype=np.int8))
    s = torch.from_numpy(rng.random((2, 3, 2, 48), dtype=np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 4, 64)).astype(np.float32))
    before = (quant_mm.quant_matmul4.launches,
              quant_mm.quant_matmul_experts_stacked4.launches)
    got = quant_mm.quant_matmul_experts_stacked4(x, q, s, 1)
    got2 = quant_mm.quant_matmul4(x[0], q[1], s[1], layer=0)
    assert (quant_mm.quant_matmul4.launches,
            quant_mm.quant_matmul_experts_stacked4.launches) == before
    w = quant.dequantize4(QTensor4(q[1], s[1]), torch.float64)
    want = torch.einsum("ech,ehf->ecf", x.double(), w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got2.numpy(), (x[0].double() @ w[0]).numpy(),
                               rtol=1e-5, atol=1e-4)
