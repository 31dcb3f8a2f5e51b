"""The port's prefill attention (models/layers.attend_gqa_auto, kernel D's
plain version on CPU tensors) against the reference's non-Pallas math
for the same function, ``attend_gqa_auto(q, k, v, causal_mask(Sq, Skv,
off))`` on the CPU (the Pallas library's ``flash_attention`` behind
``attend_gqa_causal0`` is TPU-only and has no interpret mode).

Inputs come from a numpy seed and cover offset 0 (whole prompt), a
chunk offset over a wider carry, a prefix offset, ragged query lengths
and kv slots past the last query (never visible). Tolerances: 1e-5 of
max|ref| in f32 (reduction order only); 1e-2 in bf16 (the two frameworks
round the probabilities and the output at different places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import layers as ref_layers
from p2p_llm_chat_tpu_torch.models import layers
from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
    prefill_attention, prefill_attention_reference)

torch.set_num_threads(2)
pytestmark = pytest.mark.model

# (R, Sq, Skv, q_offset, Hq, Hkv, D)
CASES = {
    "whole": (2, 24, 24, 0, 4, 2, 32),
    "chunk": (2, 16, 64, 32, 4, 2, 32),
    "prefix": (3, 20, 57, 37, 6, 2, 16),
    "ragged": (1, 13, 13, 0, 4, 4, 32),
    "unwritten_tail": (2, 7, 40, 5, 8, 2, 32),
}
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _inputs(case: str, seed: int = 0):
    R, Sq, Skv, off, Hq, Hkv, D = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(R, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(R, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(R, Skv, Hkv, D)).astype(np.float32)
    return q, k, v, off


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_attend_gqa_auto_matches_reference(case, dtype):
    q, k, v, off = _inputs(case)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    mask = ref_layers.causal_mask(q.shape[1], k.shape[1], off)
    ref = np.asarray(ref_layers.attend_gqa_auto(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        mask).astype(jnp.float32))
    got = layers.attend_gqa_auto(torch.from_numpy(q).to(tdt),
                                 torch.from_numpy(k).to(tdt),
                                 torch.from_numpy(v).to(tdt), off)
    assert got.dtype == tdt and got.shape == q.shape
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), err


def test_causal0_is_offset_zero_over_equal_lengths():
    q, k, v, _ = _inputs("whole", seed=1)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    assert torch.equal(layers.attend_gqa_causal0(q, k, v),
                       layers.attend_gqa_auto(q, k, v, 0))


def test_chunks_agree_with_the_whole_prompt():
    """The chunked-prefill shape on the plain path: each chunk's rows,
    computed at its offset over the full-width carry, match the same rows
    of the whole-prompt call (f32; kernel D makes them bitwise equal on
    the card, checked by chip_smoke.py)."""
    rng = np.random.default_rng(2)
    R, S, C, Hq, Hkv, D = 2, 48, 16, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(R, S, h, D)).astype(
        np.float32)) for h in (Hq, Hkv, Hkv))
    whole = layers.attend_gqa_auto(q, k, v, 0)
    for off in range(0, S, C):
        part = layers.attend_gqa_auto(q[:, off:off + C], k, v, off)
        np.testing.assert_allclose(part.numpy(), whole[:, off:off + C],
                                   rtol=0, atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu_and_launches_nothing():
    q, k, v, off = _inputs("prefix", seed=3)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    prefill_attention.launches = 0
    assert torch.equal(prefill_attention(q, k, v, off),
                       prefill_attention_reference(q, k, v, off))
    assert prefill_attention.launches == 0
    # A tensor on neither the CPU nor a card is refused, never computed.
    with pytest.raises(ValueError, match="unsupported device"):
        prefill_attention(q.to("meta"), k.to("meta"), v.to("meta"), off)
