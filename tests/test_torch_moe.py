"""The port's mixtral family against the reference on the same weights
(carried across with models/convert.params_from_numpy).

- ``moe_mlp`` on f32 activations with the fused ``wgu_e``, int8 and int4,
  dropless and with a bounded capacity that overflows: within 1e-5 of the
  output scale (f32 summation order only — routing, slots and overflow
  drops are exact integer decisions and must agree);
- prefill + paged decode logits on ``tiny-moe`` with f32 activations and
  int8 or int4 weights over an int8 pool: 2e-3 of the logit scale (as the
  llama test: a k/v element one ulp apart before pool quantization can
  land one int8 step apart);
- greedy streams identical token for token over 16 steps on the
  quote-workload weights (models/synth.quote_params), int8 and int4;
- routing ties break to the lower expert index, as ``jax.lax.top_k``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu_torch.models import family_for, mixtral
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.ops import paged_kv

torch.set_num_threads(2)
pytestmark = pytest.mark.model

PS = 8


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=["int8", "int4"])
def moe_params(request):
    """tiny-moe, fused and quantized by the reference, f32 activations."""
    cfg = ref_config("tiny-moe")
    params = ref_mixtral.init_params_quantized(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32, quant=request.param)
    return request.param, params, params_from_numpy(_np_tree(params),
                                                    device="cpu")


@pytest.mark.parametrize("capacity", [None, 3])
def test_moe_mlp_matches_reference(moe_params, capacity):
    """T = 12 tokens, top-2 of 4 experts: capacity 3 overflows (24
    selections over 12 slots), so the slot order decides which tokens
    keep their MLP contribution."""
    quant, ref_params, params = moe_params
    cfg = ref_config("tiny-moe")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, cfg.hidden_size)).astype(np.float32)
    layer = 1
    lp = ref_params["layers"]

    def at(w):
        return type(w)(q=w.q[layer], s=w.s[layer])

    want = ref_mixtral.moe_mlp(jnp.asarray(x), lp["router"][layer], None,
                               None, at(lp["w_down"]),
                               cfg.num_experts_per_tok, capacity=capacity,
                               w_gu=at(lp["wgu_e"]))
    layers = params["layers"]
    assert type(layers["wgu_e"]).__name__ == (
        "QTensor4" if quant == "int4" else "QTensor")
    got = mixtral.moe_mlp(torch.from_numpy(x), layers["router"], None, None,
                          layers["w_down"], cfg.num_experts_per_tok,
                          capacity=capacity, w_gu=layers["wgu_e"],
                          layer=layer)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)
    if capacity is not None:
        # Some token lost its MLP output: the overflow path ran.
        dropped = np.asarray(ref_mixtral.moe_mlp(
            jnp.asarray(x), lp["router"][layer], None, None,
            at(lp["w_down"]), cfg.num_experts_per_tok, capacity=None,
            w_gu=at(lp["wgu_e"])))
        assert not np.allclose(dropped, want)


def test_moe_mlp_unfused_matches_fused():
    """w_gate / w_up run as two batched products; fusing them into
    wgu_e changes nothing (the per-column dots are the same)."""
    cfg = get_config("tiny-moe")
    params = mixtral.init_params_quantized(cfg, seed=3, dtype=torch.float32,
                                           quant="int8", device="cpu")
    layers = params["layers"]
    F = cfg.intermediate_size
    wgu = layers["wgu_e"]
    gate = type(wgu)(wgu.q[..., :F].contiguous(), wgu.s[..., :F].contiguous())
    up = type(wgu)(wgu.q[..., F:].contiguous(), wgu.s[..., F:].contiguous())
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 5, cfg.hidden_size)).astype(np.float32))
    fused = mixtral.moe_mlp(x, layers["router"], None, None,
                            layers["w_down"], 2, w_gu=wgu, layer=0)
    split = mixtral.moe_mlp(x, layers["router"], gate, up, layers["w_down"],
                            2, layer=0)
    assert torch.equal(fused, split)


def test_top_k_ties_break_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    w, i = mixtral._top_k(probs, 2)
    ref_w, ref_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))


def test_capacity_rule_matches_reference():
    cfg, ref_cfg = get_config("mixtral-8x7b"), ref_config("mixtral-8x7b")
    for tokens in (1, 8, 16, 100, 2048):
        assert mixtral._capacity_for(cfg, tokens, mixtral._AUTO) == \
            ref_mixtral._capacity_for(ref_cfg, tokens, ref_mixtral._AUTO)
    assert mixtral._capacity_for(get_config("tiny-moe"), 64,
                                 mixtral._AUTO) is None
    assert family_for(cfg) is mixtral


class _Pair:
    """The same prompts prefilled into a reference pool and a port pool
    (tiny-moe, int8 pool)."""

    def __init__(self, params, prompts, max_pages=8):
        self.cfg_ref = ref_config("tiny-moe")
        self.cfg = get_config("tiny-moe")
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
        logits, small = ref_mixtral.prefill(params, self.cfg_ref,
                                            jnp.asarray(toks),
                                            jnp.asarray(lens), small,
                                            last_only=True)
        self.ref_logits = np.asarray(logits)
        rc = ref_kv.PagedKVCache.create(self.cfg_ref, B, N, PS,
                                        max_pages_per_row=max_pages,
                                        dtype=dt, quantized=True)
        self.ref_cache = ref_kv.write_prefill_batch(
            rc, small.k, small.v, jnp.arange(B), jnp.asarray(lens),
            jnp.asarray(tables))
        tlogits, k_all, v_all = mixtral.prefill(
            self.params, self.cfg, torch.from_numpy(toks).long(),
            torch.from_numpy(lens), last_only=True)
        self.logits = tlogits.numpy()
        self.cache = paged_kv.PagedKVCache.create(
            self.cfg, B, N, PS, max_pages_per_row=max_pages,
            dtype=self.params["embed"].dtype, quantized=True, device="cpu")
        paged_kv.write_prefill_batch(self.cache, k_all, v_all,
                                     torch.arange(B), torch.from_numpy(lens),
                                     torch.from_numpy(tables))

    def step(self, tokens: np.ndarray, active: np.ndarray, ref: bool = True):
        pages = int(max(1, -(-int(self.cache.lengths.max()) // PS)))
        ref_logits = None
        if ref:
            ref_logits, self.ref_cache = ref_mixtral.decode_step_paged(
                self.params_ref, self.cfg_ref, jnp.asarray(tokens[:, None]),
                self.ref_cache, active=jnp.asarray(active), pages=pages)
            ref_logits = np.asarray(ref_logits)[:, 0]
        logits, _ = mixtral.decode_step_paged(
            self.params, self.cfg, torch.from_numpy(tokens[:, None]).long(),
            self.cache, torch.from_numpy(active), pages=pages)
        return ref_logits, logits.numpy()[:, 0]


def test_decode_step_paged_logits_match(moe_params):
    quant, params, _ = moe_params
    tol = 2e-3
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(3, 500, size=n)) for n in (5, 12, 1)]
    pair = _Pair(params, prompts)
    scale = float(np.abs(pair.ref_logits).max())
    np.testing.assert_allclose(pair.logits, pair.ref_logits, rtol=tol,
                               atol=tol * scale)
    active = np.array([True, True, False])
    toks = pair.ref_logits[:, 0].argmax(-1).astype(np.int64)
    for _ in range(3):
        ref, got = pair.step(toks, active)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)
        toks = ref.argmax(-1).astype(np.int64)
    np.testing.assert_array_equal(pair.cache.lengths.numpy(),
                                  np.asarray(pair.ref_cache.lengths))
    assert pair.cache.lengths.tolist() == [8, 15, 1]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_greedy_streams_identical_on_quote_weights(quant):
    params = quote_params(ref_config("tiny-moe"), jax.random.PRNGKey(3),
                          quantized=True, quant=quant)
    assert ref_quant.quant_mode(params) == quant
    prompts = [[1, 40, 41, 42], [1, 300, 301, 302, 303, 304, 305]]
    pair = _Pair(params, prompts, max_pages=4)
    active = np.array([True, True])
    ref_tok = pair.ref_logits[:, 0].argmax(-1).astype(np.int64)
    tok = pair.logits[:, 0].argmax(-1).astype(np.int64)
    ref_stream, stream = [ref_tok], [tok]
    for _ in range(16):
        ref_l, _ = pair.step(ref_tok, active)
        ref_tok = ref_l.argmax(-1).astype(np.int64)
        ref_stream.append(ref_tok)
    # The port runs its OWN stream (fed its own argmax) from a fresh pair.
    pair2 = _Pair(params, prompts, max_pages=4)
    for _ in range(16):
        _, got = pair2.step(tok, active, ref=False)
        tok = got.argmax(-1).astype(np.int64)
        stream.append(tok)
    np.testing.assert_array_equal(np.stack(stream), np.stack(ref_stream))
