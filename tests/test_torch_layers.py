"""Layer primitives of the port against the reference on the same
numpy-seeded inputs, in f32.

- ``rope_frequencies`` for every config, the llama3.1 ``RopeScaling``
  ramp included: 1e-6 relative (the same f32 formula; only the pow
  kernel differs between the frameworks).
- ``apply_rope``, ``rms_norm``, ``attend_gqa`` with causal and length
  masks, ``repeat_kv``: 1e-5 of the output scale (f32 reduction order
  only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import layers as ref_layers
from p2p_llm_chat_tpu.models.configs import CONFIGS as REF_CONFIGS
from p2p_llm_chat_tpu_torch.models import layers
from p2p_llm_chat_tpu_torch.models.configs import get_config

torch.set_num_threads(2)

TOL = 1e-5


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("name", ["tiny", "llama3.1-8b", "llama3.2-1b"])
def test_rope_frequencies_match(name):
    want = np.asarray(ref_layers.rope_frequencies(REF_CONFIGS[name]))
    got = layers.rope_frequencies(get_config(name)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_apply_rope_and_rms_norm_match():
    rng = np.random.default_rng(0)
    cfg = get_config("llama3.1-8b")
    inv = layers.rope_frequencies(cfg)
    x = rng.normal(size=(2, 5, 4, cfg.head_dim)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7000, 7001, 9, 130000, 5]], np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(inv.numpy()))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv),
           want, 2e-5)

    h = rng.normal(size=(3, 7, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = ref_layers.rms_norm(jnp.asarray(h), jnp.asarray(scale), 1e-5)
    _close(layers.rms_norm(torch.from_numpy(h), torch.from_numpy(scale), 1e-5),
           want)


@pytest.mark.parametrize("rep", [1, 4])
def test_attend_gqa_matches_with_causal_and_length_masks(rep):
    rng = np.random.default_rng(rep)
    B, S, Hkv, D = 3, 9, 2, 16
    q = rng.normal(size=(B, S, Hkv * rep, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    lengths = np.array([9, 4, 1], np.int32)
    ref_mask = (ref_layers.causal_mask(S, S, 0)
                & ref_layers.length_mask(S, jnp.asarray(lengths)))
    mask = (layers.causal_mask(S, S, 0)
            & layers.length_mask(S, torch.from_numpy(lengths)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    want = ref_layers.attend_gqa(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), ref_mask)
    got = layers.attend_gqa(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), mask)
    _close(got, want)
    np.testing.assert_array_equal(
        layers.repeat_kv(torch.from_numpy(k), rep).numpy(),
        np.asarray(ref_layers.repeat_kv(jnp.asarray(k), rep)))
