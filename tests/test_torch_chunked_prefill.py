"""Chunked prefill in the port, held against the reference.

- model level: the port's ``prefill_chunk`` (llama ``tiny`` and mixtral
  ``tiny-moe``, f32 weights carried across with params_from_numpy) against
  the reference's ``prefill_chunk`` over the same chunk ladder — every
  chunk's logits and the carried k/v within 1e-4 of their scale (f32
  reduction order only) — including a ladder resumed after a prefix at an
  odd offset;
- ops level: ``write_prefill_chunk`` leaves the pool BITWISE equal to the
  reference's (int8 bytes and head-major scales, or bf16), for
  page-aligned, multi-page, sub-page and unaligned starts (page 0, the
  garbage page, excluded as in test_torch_paged.py);
- scheduler level: on the quote-workload weights, the port's greedy
  ``context`` ids are the same chunked (C=16) and single-shot, and equal
  the JAX engine's; a top bucket that the chunk width does not divide
  admits in one piece.
"""

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
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import (params_from_numpy,
                                                   tensor_from_numpy)
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

REF_FAMILY = {"tiny": ref_llama, "tiny-moe": ref_mixtral}


# -- model level --------------------------------------------------------------

@pytest.mark.parametrize("ladder", ["from0", "after_prefix"])
@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_prefill_chunk_matches_reference(config, ladder):
    rcfg, cfg = ref_config(config), get_config(config)
    ref = REF_FAMILY[config]
    params = ref.init_params(rcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    fam = family_for(cfg)
    tparams = fam.fuse_params(params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    R, W, C = 2, 48, 16
    # After a prefix: a first chunk of 19 tokens, then the 16-wide ladder
    # at odd offsets (the prefix-continuation shape).
    cuts = ([0, 16, 32, 48] if ladder == "from0" else [0, 19, 35, 48])
    toks = np.random.default_rng(3).integers(3, rcfg.vocab_size, (R, W))
    cache = KVCache.create(rcfg, R, W, dtype=jnp.float32)
    ck, cv = fam.new_carry(cfg, R, W, torch.float32, "cpu")
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        want, cache = ref.prefill_chunk(params, rcfg,
                                        jnp.asarray(toks[:, lo:hi]), cache,
                                        lo)
        got = fam.prefill_chunk(tparams, cfg,
                                torch.from_numpy(toks[:, lo:hi]).long(), ck,
                                cv, lo)
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    for name, t in (("k", ck), ("v", cv)):
        w = np.asarray(getattr(cache, name))
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_last_idx_gathers_each_rows_last_prompt_position():
    cfg = get_config("tiny")
    fam = family_for(cfg)
    params = fam.init_params_quantized(cfg, seed=2, quant="", device="cpu",
                                       dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        3, cfg.vocab_size, (2, 16)))
    ck, cv = fam.new_carry(cfg, 2, 16, torch.float32, "cpu")
    full = fam.prefill_chunk(params, cfg, toks, ck, cv, 0)
    ck, cv = fam.new_carry(cfg, 2, 16, torch.float32, "cpu")
    last = fam.prefill_chunk(params, cfg, toks, ck, cv, 0,
                             torch.tensor([15, 6]))
    assert last.shape == (2, 1, cfg.vocab_size)
    assert torch.equal(last[0, 0], full[0, 15])
    assert torch.equal(last[1, 0], full[1, 6])


# -- ops level: write_prefill_chunk ------------------------------------------

def _t(x) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _assert_pools_equal(got: paged_kv.PagedKVCache, ref) -> None:
    for name in ("k", "v", "k_scale", "v_scale"):
        r = getattr(ref, name)
        if r is None:
            assert getattr(got, name) is None
            continue
        g = getattr(got, name)[:, 1:]
        r = np.asarray(r)[:, 1:]
        if g.dtype == torch.bfloat16:
            g, r = g.view(torch.int16), r.view(np.int16)
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    np.testing.assert_array_equal(got.page_table.numpy(),
                                  np.asarray(ref.page_table))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


@pytest.mark.parametrize("cuts", [(0, 16, 32, 48, 64), (0, 32, 64),
                                  (0, 8, 16, 24, 64), (0, 21, 37, 64)],
                         ids=["page", "2page", "subpage", "unaligned"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_write_prefill_chunk_bitwise(quantized, cuts):
    rng = np.random.default_rng(len(cuts))
    rcfg, PS, R, S = ref_config("tiny"), 16, 3, 64
    mppr, N = S // PS + 1, 3 * (S // PS) + 4
    L, Hkv, D = rcfg.num_layers, rcfg.num_kv_heads, rcfg.head_dim
    rc = ref_kv.PagedKVCache.create(rcfg, 4, N, PS, max_pages_per_row=mppr,
                                    dtype=jnp.bfloat16, quantized=quantized)
    tc = paged_kv.PagedKVCache.create(get_config("tiny"), 4, N, PS,
                                      max_pages_per_row=mppr,
                                      dtype=torch.bfloat16,
                                      quantized=quantized, device="cpu")
    k = jnp.asarray(rng.normal(size=(L, R, S, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(L, R, S, Hkv, D)), jnp.bfloat16)
    tables = np.zeros((R, mppr), np.int32)
    for r, n in enumerate((4, 3, 2)):           # short rows: tail in page 0
        tables[r, :n] = 1 + r * (S // PS) + np.arange(n)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rc = ref_kv.write_prefill_chunk(rc, k[:, :, lo:hi], v[:, :, lo:hi],
                                        jnp.asarray(tables), lo)
        paged_kv.write_prefill_chunk(tc, _t(k[:, :, lo:hi]),
                                     _t(v[:, :, lo:hi]),
                                     torch.from_numpy(tables), lo)
        _assert_pools_equal(tc, rc)


# -- scheduler level ----------------------------------------------------------

PROMPTS = ("Draft a short reply to: are we still on for ten?",
           "Summarize the thread about the picnic and the office move in "
           "one sentence, please, before noon today")


def _contexts(engine, prompts, ref: bool) -> list:
    out = []
    for prompt in prompts:
        if ref:
            stats = RefStats()
            ref_collect(engine, RefRequest(
                prompt=prompt, options=RefOptions(max_tokens=12)), stats)
        else:
            stats = RequestStats()
            collect(engine, GenerateRequest(
                prompt=prompt, options=GenerateOptions(max_tokens=12)),
                stats)
        out.append(stats.context)
    return out


def test_scheduler_chunked_single_shot_and_reference_agree():
    rcfg = ref_config("tiny")
    params = quote_params(rcfg, jax.random.PRNGKey(5), quantized=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    cfg = get_config("tiny")
    common = dict(num_slots=2, max_seq=128, page_size=16, kv_quant=True)
    ref_engine = TPUEngine(params, rcfg, RefByteTokenizer(rcfg.vocab_size),
                           kv_mode="paged", prefix_cache=False,
                           decode_fuse_max=1, prefill_chunk=0, **common)
    engines = {C: TorchEngine(tparams, cfg, ByteTokenizer(cfg.vocab_size),
                              prefix_cache=False, prefill_chunk=C,
                              device="cpu", **common) for C in (16, 0)}
    try:
        want = _contexts(ref_engine, PROMPTS, ref=True)
        for C, engine in engines.items():
            assert _contexts(engine, PROMPTS, ref=False) == want, C
        # 49 + 1 tokens -> bucket 64 (4 chunks), 101 -> 128 (8 chunks).
        snap = engines[16].metrics_snapshot()
        assert snap["prefill_chunks_total"] == 4 + 8
        assert engines[0].metrics_snapshot()["prefill_chunks_total"] == 0
        assert snap["serve_kv_free_pages"] == snap["serve_kv_total_pages"]
    finally:
        ref_engine.stop()
        for engine in engines.values():
            engine.stop()


def test_non_multiple_top_bucket_admits_in_one_piece():
    """max_seq caps the top bucket at 80, which the chunk width 32 does
    not divide: that bucket admits in one piece (a ladder stepping past
    80 would never reach its final chunk), with the same output."""
    rcfg = ref_config("tiny")
    params = params_from_numpy(jax.tree.map(np.asarray, quote_params(
        rcfg, jax.random.PRNGKey(5), quantized=True)), device="cpu")
    cfg = get_config("tiny")
    prompt = PROMPTS[1][:70]                      # 71 tokens -> bucket 80
    engines = [TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size),
                           num_slots=2, max_seq=80, page_size=16,
                           kv_quant=True, prefix_cache=False,
                           prefill_chunk=C, device="cpu") for C in (32, 0)]
    try:
        got = [_contexts(e, (prompt,), ref=False) for e in engines]
        assert got[0] == got[1]
        assert engines[0].metrics_snapshot()["prefill_chunks_total"] == 0
    finally:
        for e in engines:
            e.stop()
