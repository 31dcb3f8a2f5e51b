"""The write-then-attend decode branch of the port (``PAGED_ATTN_IMPL`` =
kernel | flash over a bf16 pool) against the reference's, and its
serving rules.

- An int8 pool is served under the gather impl only: the scheduler
  refuses ``kv_quant=True`` with a non-gather impl at construction, in
  the reference's words (p2p_llm_chat_tpu/serve/scheduler.py:427-444),
  whether the impl comes as an argument, as the module default or from
  the env of ``build_engine_from_env``.
- ``decode_step_paged`` under the branch, llama ``tiny`` and mixtral
  ``tiny-moe`` with f32 activations, int8 weights and an f32 pool,
  against the reference's with ``_DEFAULT_IMPL = "kernel"`` (its Pallas
  ``_paged_attention_kernel`` in interpret mode): logits within 1e-4 of
  the logit scale (f32 summation order only) and pools within 1e-5 after
  every step (the k/v come from projections summed in another order; the
  write itself is bitwise, tests/test_torch_paged.py); greedy streams
  identical over 16 steps on the quote-workload weights with a bf16 pool.
- The scheduler sizes the decode window to hold the slot each tick
  writes: with a prompt of exactly one page every tick's window covers
  ``lengths + 1``, and the greedy ``context`` ids equal the reference
  engine's under the same impl.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models import family_for, llama
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.ops import paged_attention as pa
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import (TorchEngine,
                                                 build_engine_from_env)
from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

ref_pa = importlib.import_module("p2p_llm_chat_tpu.ops.paged_attention")

torch.set_num_threads(2)
pytestmark = pytest.mark.model

PS = 8
_REF_FAMILY = {"tiny": ref_llama, "tiny-moe": ref_mixtral}


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_params():
    return llama.init_params_quantized(get_config("tiny"), device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "flash"])
def test_int8_pool_with_a_non_gather_impl_is_refused(impl, tiny_params,
                                                     monkeypatch):
    cfg = get_config("tiny")
    tok = ByteTokenizer(cfg.vocab_size)
    msg = "kv_quant=True requires the gather attention impl"
    with pytest.raises(ValueError, match=msg):
        BatchScheduler(tiny_params, cfg, tok, kv_quant=True, attn_impl=impl,
                       kv_mode="paged", device="cpu")
    monkeypatch.setattr(pa, "_DEFAULT_IMPL", impl)
    with pytest.raises(ValueError, match=msg):
        BatchScheduler(tiny_params, cfg, tok, kv_quant=True, kv_mode="paged",
        device="cpu")
    monkeypatch.setattr(pa, "_DEFAULT_IMPL", "gather")
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny",
                     SERVE_KV="paged",
                     SERVE_QUANT="int8", SERVE_KV_QUANT="int8",
                     SERVE_WARMUP="0", PAGED_ATTN_IMPL=impl).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=msg):
        build_engine_from_env()
    # A bf16 pool serves under the same impl; a misspelt impl raises.
    monkeypatch.setenv("SERVE_KV_QUANT", "")
    engine = build_engine_from_env()
    assert engine.scheduler.attn_impl == impl
    engine.stop()
    monkeypatch.setenv("PAGED_ATTN_IMPL", "kernal")
    with pytest.raises(ValueError, match="gather|kernel|flash"):
        build_engine_from_env()


class _Pair:
    """The same prompts prefilled into a reference pool and a port pool
    (no quantization of the pool)."""

    def __init__(self, config, params, prompts, max_pages=8):
        self.ref = _REF_FAMILY[config]
        self.cfg_ref = ref_config(config)
        self.cfg = get_config(config)
        self.fam = family_for(self.cfg)
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
        logits, small = self.ref.prefill(params, self.cfg_ref,
                                         jnp.asarray(toks), jnp.asarray(lens),
                                         small, last_only=True)
        self.ref_logits = np.asarray(logits)
        rc = ref_kv.PagedKVCache.create(self.cfg_ref, B, N, PS,
                                        max_pages_per_row=max_pages,
                                        dtype=dt, quantized=False)
        self.ref_cache = ref_kv.write_prefill_batch(
            rc, small.k, small.v, jnp.arange(B), jnp.asarray(lens),
            jnp.asarray(tables))
        tlogits, k_all, v_all = self.fam.prefill(
            self.params, self.cfg, torch.from_numpy(toks).long(),
            torch.from_numpy(lens), last_only=True)
        self.logits = tlogits.numpy()
        self.cache = paged_kv.PagedKVCache.create(
            self.cfg, B, N, PS, max_pages_per_row=max_pages,
            dtype=self.params["embed"].dtype, device="cpu")
        paged_kv.write_prefill_batch(self.cache, k_all, v_all,
                                     torch.arange(B), torch.from_numpy(lens),
                                     torch.from_numpy(tables))

    def step(self, tokens, active, ref: bool = True):
        # Write-then-attend: the window holds the slot this step writes.
        pages = -(-(int(self.cache.lengths.max()) + 1) // PS)
        ref_logits = None
        if ref:
            ref_logits, self.ref_cache = self.ref.decode_step_paged(
                self.params_ref, self.cfg_ref, jnp.asarray(tokens[:, None]),
                self.ref_cache, active=jnp.asarray(active), pages=pages)
            ref_logits = np.asarray(ref_logits)[:, 0]
        logits, _ = self.fam.decode_step_paged(
            self.params, self.cfg, torch.from_numpy(tokens[:, None]).long(),
            self.cache, torch.from_numpy(active), pages=pages,
            impl="kernel")
        return ref_logits, logits.numpy()[:, 0]

    def assert_pools_close(self, tol: float) -> None:
        for name in ("k", "v"):
            got = getattr(self.cache, name)[:, 1:].float().numpy()
            want = np.asarray(getattr(self.ref_cache, name)[:, 1:],
                              np.float32)
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=name)
        np.testing.assert_array_equal(self.cache.lengths.numpy(),
                                      np.asarray(self.ref_cache.lengths))


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_decode_step_write_then_attend_matches_reference(config,
                                                         monkeypatch):
    monkeypatch.setattr(ref_pa, "_DEFAULT_IMPL", "kernel")
    params = _REF_FAMILY[config].init_params_quantized(
        ref_config(config), jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    # Row 1 sits on a page boundary (its first write opens page 2).
    prompts = [list(rng.integers(3, 500, size=n)) for n in (5, 8, 1)]
    pair = _Pair(config, params, prompts)
    scale = float(np.abs(pair.ref_logits).max())
    tol = 1e-4
    np.testing.assert_allclose(pair.logits, pair.ref_logits, rtol=tol,
                               atol=tol * scale)
    active = np.array([True, True, False])
    toks = pair.ref_logits[:, 0].argmax(-1).astype(np.int64)
    before = (pa.paged_attention.launches, pa.paged_attention_append.launches)
    for _ in range(3):
        ref, got = pair.step(toks, active)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)
        pair.assert_pools_close(1e-5)
        toks = ref.argmax(-1).astype(np.int64)
    # Parked row 2 never advanced; the plain versions ran (no launches).
    assert pair.cache.lengths.tolist() == [8, 11, 1]
    assert (pa.paged_attention.launches,
            pa.paged_attention_append.launches) == before


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_write_then_attend_greedy_streams_on_quote_weights(config,
                                                           monkeypatch):
    monkeypatch.setattr(ref_pa, "_DEFAULT_IMPL", "kernel")
    params = quote_params(ref_config(config), jax.random.PRNGKey(3),
                          quantized=True)
    prompts = [[1, 40, 41, 42], [1, 300, 301, 302, 303, 304, 305, 306]]
    pair = _Pair(config, params, prompts, max_pages=4)
    active = np.array([True, True])
    ref_tok = pair.ref_logits[:, 0].argmax(-1).astype(np.int64)
    tok = pair.logits[:, 0].argmax(-1).astype(np.int64)
    ref_stream, stream = [ref_tok], [tok]
    for _ in range(16):
        ref_l, _ = pair.step(ref_tok, active)
        ref_tok = ref_l.argmax(-1).astype(np.int64)
        ref_stream.append(ref_tok)
    # The port runs its OWN stream (fed its own argmax) from a fresh pair.
    pair2 = _Pair(config, params, prompts, max_pages=4)
    for _ in range(16):
        _, got = pair2.step(tok, active, ref=False)
        tok = got.argmax(-1).astype(np.int64)
        stream.append(tok)
    np.testing.assert_array_equal(np.stack(stream), np.stack(ref_stream))


def test_scheduler_window_holds_the_written_slot(monkeypatch):
    """A 15-byte prompt + BOS fills exactly one 16-slot page, so the first
    tick writes position 16: a window of ceil(ctx_len / page_size) pages
    would leave that slot (the current token) out of its own attention.
    Every tick's window must cover lengths + 1 of each live row, and the
    greedy context ids must equal the reference engine's."""
    monkeypatch.setattr(ref_pa, "_DEFAULT_IMPL", "kernel")
    cfg = ref_config("tiny")
    params = quote_params(cfg, jax.random.PRNGKey(5), quantized=True)
    seen = []
    real = llama.decode_step_paged

    def spy(params, config, tokens, cache, active=None, *, pages, **kw):
        live = cache.lengths[active] if active is not None else cache.lengths
        if live.numel():
            seen.append((int(live.max()) + 1, pages * cache.page_size))
        return real(params, config, tokens, cache, active, pages=pages, **kw)

    monkeypatch.setattr(llama, "decode_step_paged", spy)
    ref_engine = TPUEngine(params, cfg, RefByteTokenizer(cfg.vocab_size),
                           num_slots=2, max_seq=128, kv_mode="paged",
                           page_size=16, kv_quant=False, prefix_cache=False,
                           decode_fuse_max=1, prefill_chunk=0)
    engine = TorchEngine(params_from_numpy(_np_tree(params), device="cpu"),
                         get_config("tiny"), ByteTokenizer(cfg.vocab_size),
                         num_slots=2, max_seq=128, page_size=16,
                         kv_quant=False, prefix_cache=False,
                         attn_impl="kernel", kv_mode="paged",
                         device="cpu")
    try:
        for prompt in ("the quick brown", "a" * 31):
            assert len(prompt) + 1 in (16, 32)          # + BOS: whole pages
            ref_stats, stats = RefStats(), RequestStats()
            ref_collect(ref_engine, RefRequest(
                prompt=prompt, options=RefOptions(max_tokens=12)), ref_stats)
            collect(engine, GenerateRequest(
                prompt=prompt, options=GenerateOptions(max_tokens=12)), stats)
            assert stats.completion_tokens > 0
            assert stats.context == ref_stats.context
    finally:
        ref_engine.stop()
        engine.stop()
    assert seen and all(need <= window for need, window in seen), seen
