"""The port's llama decoder against the reference on the same weights
(carried across with models/convert.params_from_numpy).

- prefill + paged decode logits on ``tiny`` with f32 activations and int8
  weights: f32 pools agree to 1e-4 of the logit scale (f32 reduction
  order only); int8 pools to 2e-3 (a k/v element one ulp apart before
  quantization can land on the other side of a rounding boundary and
  move that element by one int8 step);
- greedy streams are IDENTICAL token for token over 16 decode steps on
  the quote-workload weights (models/synth.quote_params), whose successor
  margins keep greedy argmax stable under rounding differences — random
  init is near-tied and is compared by logits instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu_torch.models import llama
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.ops import paged_kv

torch.set_num_threads(2)
pytestmark = pytest.mark.model

PS = 8


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


class _Pair:
    """The same prompts prefilled into a reference pool and a port pool."""

    def __init__(self, params, prompts, quantized, max_pages=8):
        self.cfg_ref = ref_config("tiny")
        self.cfg = get_config("tiny")
        self.params_ref = params
        self.params = params_from_numpy(_np_tree(params), device="cpu")
        B = len(prompts)
        dt = params["embed"].dtype
        S = 16
        toks = np.zeros((B, S), np.int32)
        lens = np.array([len(p) for p in prompts], np.int32)
        for b, p in enumerate(prompts):
            toks[b, :len(p)] = p
        tables = np.stack([1 + b * max_pages + np.arange(max_pages)
                           for b in range(B)]).astype(np.int32)
        N = B * max_pages + 1
        small = KVCache.create(self.cfg_ref, B, S, dtype=dt)
        logits, small = ref_llama.prefill(params, self.cfg_ref,
                                          jnp.asarray(toks),
                                          jnp.asarray(lens), small,
                                          last_only=True)
        self.ref_logits = np.asarray(logits)
        rc = ref_kv.PagedKVCache.create(self.cfg_ref, B, N, PS,
                                        max_pages_per_row=max_pages,
                                        dtype=dt, quantized=quantized)
        self.ref_cache = ref_kv.write_prefill_batch(
            rc, small.k, small.v, jnp.arange(B), jnp.asarray(lens),
            jnp.asarray(tables))
        tlogits, k_all, v_all = llama.prefill(
            self.params, self.cfg, torch.from_numpy(toks).long(),
            torch.from_numpy(lens), last_only=True)
        self.logits = tlogits.numpy()
        tdt = self.params["embed"].dtype
        self.cache = paged_kv.PagedKVCache.create(
            self.cfg, B, N, PS, max_pages_per_row=max_pages, dtype=tdt,
            quantized=quantized, device="cpu")
        paged_kv.write_prefill_batch(self.cache, k_all, v_all,
                                     torch.arange(B), torch.from_numpy(lens),
                                     torch.from_numpy(tables))

    def step(self, tokens: np.ndarray, active: np.ndarray):
        pages = int(max(1, -(-int(self.cache.lengths.max()) // PS)))
        ref_logits, self.ref_cache = ref_llama.decode_step_paged(
            self.params_ref, self.cfg_ref, jnp.asarray(tokens[:, None]),
            self.ref_cache, active=jnp.asarray(active), pages=pages)
        logits, _ = llama.decode_step_paged(
            self.params, self.cfg, torch.from_numpy(tokens[:, None]).long(),
            self.cache, torch.from_numpy(active), pages=pages)
        return np.asarray(ref_logits)[:, 0], logits.numpy()[:, 0]


@pytest.mark.parametrize("quantized,tol", [(False, 1e-4), (True, 2e-3)])
def test_decode_step_paged_logits_match(quantized, tol):
    params = ref_llama.init_params_quantized(
        ref_config("tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(3, 500, size=n)) for n in (5, 12, 1)]
    pair = _Pair(params, prompts, quantized)
    scale = float(np.abs(pair.ref_logits).max())
    np.testing.assert_allclose(pair.logits, pair.ref_logits, rtol=tol,
                               atol=tol * scale)
    active = np.array([True, True, False])
    toks = pair.ref_logits[:, 0].argmax(-1).astype(np.int64)
    for _ in range(3):
        ref, got = pair.step(toks, active)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)
        toks = ref.argmax(-1).astype(np.int64)
    # Parked row 2 never advanced; active rows advanced 3 slots.
    np.testing.assert_array_equal(pair.cache.lengths.numpy(),
                                  np.asarray(pair.ref_cache.lengths))
    assert pair.cache.lengths.tolist() == [8, 15, 1]


def test_greedy_streams_identical_on_quote_weights():
    params = quote_params(ref_config("tiny"), jax.random.PRNGKey(3),
                          quantized=True)
    prompts = [[1, 40, 41, 42], [1, 300, 301, 302, 303, 304, 305]]
    pair = _Pair(params, prompts, quantized=True, max_pages=4)
    active = np.array([True, True])
    ref_tok = pair.ref_logits[:, 0].argmax(-1).astype(np.int64)
    tok = pair.logits[:, 0].argmax(-1).astype(np.int64)
    ref_stream, stream = [ref_tok], [tok]
    for _ in range(16):
        ref_l, _ = pair.step(ref_tok, active)
        ref_tok = ref_l.argmax(-1).astype(np.int64)
        ref_stream.append(ref_tok)
    # The port runs its OWN stream (fed its own argmax) from a fresh pair.
    pair2 = _Pair(params, prompts, quantized=True, max_pages=4)
    for _ in range(16):
        _, got = pair2.step(tok, active)
        tok = got.argmax(-1).astype(np.int64)
        stream.append(tok)
    np.testing.assert_array_equal(np.stack(stream), np.stack(ref_stream))
