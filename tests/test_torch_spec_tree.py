"""Tree speculation in the port against the JAX package on the same numpy
inputs, on the CPU.

- ``tree_attention_mask``: exactly the reference's.
- ``verify_tree_paged`` for llama ``tiny`` and mixtral ``tiny-moe`` (f32
  activations, int8 weights carried across, random per-row trees): logits
  within 2e-3 of the logit scale on int8 pools and 1e-4 on f32 pools
  (test_torch_llama.py's tolerances), the pools after the call equal as
  test_torch_spec.py holds them.
- ``copy_slot``: pools bitwise equal to the reference's, int8 bytes and
  scales included, with source and destination positions past a row's
  table (the garbage page 0 is not compared).
- ``spec_verify_tree``, greedy: accepted, used_sib and correction
  bit-equal to the reference's on the same logits, with siblings,
  ``max_accept`` and the repeat-penalty ring; sampled: the emitted first
  token's distribution equals the warped target distribution by a seeded
  Monte-Carlo, with the sibling tested after a rejected draft, for a
  draft at the argmax and one elsewhere.
- The engine's tree ticks with a stub source that proposes a sibling
  equal to the target's argmax where its main chain is wrong (the n-gram
  source proposes none): siblings are used, the greedy stream equals the
  JAX engine's with the same stub (int8 pool), and on a bf16 pool equals
  the port's own stream with speculation off.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models import sampling as ref_sampling
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.synth import quote_params, successor_map
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models import family_for, llama, sampling
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import (params_from_numpy,
                                                   tensor_from_numpy)
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils.draft import DraftSource

ref_pa = importlib.import_module("p2p_llm_chat_tpu.ops.paged_attention")
torch.set_num_threads(2)
pytestmark = pytest.mark.model

PS = 8


def _np(x):
    return np.asarray(x)


def _t(a):
    return tensor_from_numpy(a, device="cpu")


def _random_tree(rng, B, N):
    """Random per-row trees of N nodes: node i's parent a random earlier
    node. Returns (depths [B, N], anc [B, N, N], self included)."""
    anc = np.zeros((B, N, N), bool)
    depths = np.zeros((B, N), np.int32)
    for b in range(B):
        for i in range(N):
            anc[b, i, i] = True
            if i:
                parent = rng.integers(0, i)
                anc[b, i] |= anc[b, parent]
                depths[b, i] = depths[b, parent] + 1
    return depths, anc


def test_tree_attention_mask_equals_the_reference():
    rng = np.random.default_rng(0)
    _, anc = _random_tree(rng, 3, 8)
    lengths = np.array([0, 5, 30], np.int32)
    want = ref_llama.tree_attention_mask(jnp.asarray(lengths),
                                         jnp.asarray(anc), 48)
    got = llama.tree_attention_mask(_t(lengths), _t(anc), 48)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# -- the tree verify forward --------------------------------------------------

def _prefilled(config, params, prompts, quantized, mppr=6):
    """The reference's and the port's pools after the same prefill."""
    rcfg, cfg = ref_config(config), get_config(config)
    ref_fam = ref_mixtral if rcfg.is_moe else ref_llama
    fam = family_for(cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    B, S = len(prompts), 16
    toks = np.zeros((B, S), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    tables = (1 + np.arange(B * mppr, dtype=np.int32)).reshape(B, mppr)
    N = B * mppr + 1
    dt = params["embed"].dtype
    small = KVCache.create(rcfg, B, S, dtype=dt)
    _, small = ref_fam.prefill(params, rcfg, jnp.asarray(toks),
                               jnp.asarray(lens), small, last_only=True)
    rc = ref_kv.PagedKVCache.create(rcfg, B, N, PS, max_pages_per_row=mppr,
                                    dtype=dt, quantized=quantized)
    rc = ref_kv.write_prefill_batch(rc, small.k, small.v, jnp.arange(B),
                                    jnp.asarray(lens), jnp.asarray(tables))
    _, k_all, v_all = fam.prefill(tparams, cfg, torch.from_numpy(toks).long(),
                                  torch.from_numpy(lens), last_only=True)
    cache = paged_kv.PagedKVCache.create(
        cfg, B, N, PS, max_pages_per_row=mppr, dtype=tparams["embed"].dtype,
        quantized=quantized, device="cpu")
    paged_kv.write_prefill_batch(cache, k_all, v_all, torch.arange(B),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(tables))
    return (rcfg, ref_fam, rc), (cfg, fam, tparams, cache)


@pytest.mark.parametrize("config,quantized,tol", [
    ("tiny", True, 2e-3), ("tiny", False, 1e-4), ("tiny-moe", True, 2e-3)])
def test_verify_tree_paged_equals_the_reference(config, quantized, tol):
    rcfg = ref_config(config)
    init = ref_mixtral if rcfg.is_moe else ref_llama
    params = init.init_params_quantized(rcfg, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(3, 500, size=n)) for n in (5, 12, 9)]
    (rcfg, ref_fam, rc), (cfg, fam, tparams, cache) = _prefilled(
        config, params, prompts, quantized)
    depths, anc = _random_tree(rng, 3, 8)
    toks = rng.integers(3, 500, size=(3, 8)).astype(np.int32)
    want, rc = ref_fam.verify_tree_paged(
        params, rcfg, jnp.asarray(toks), jnp.asarray(depths),
        jnp.asarray(anc), rc, pages=3)
    got, _ = fam.verify_tree_paged(tparams, cfg, torch.from_numpy(toks).long(),
                                   _t(depths), _t(anc), cache, pages=3)
    want = _np(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)
    np.testing.assert_array_equal(cache.lengths.numpy(), _np(rc.lengths))
    live = cache.page_table.numpy().reshape(-1)
    for name in ("k", "v"):
        r = _np(getattr(rc, name))[:, live].astype(np.float32)
        o = getattr(cache, name)[:, live].float().numpy()
        if quantized:
            off = np.abs(o - r)
            assert off.max() <= 1 and (off > 0).mean() < 0.01, name
        else:
            np.testing.assert_allclose(o, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_copy_slot_equals_the_reference(quantized):
    rng = np.random.default_rng(4)
    L, B, Hkv, D, mppr = 2, 4, 2, 16, 3
    N = 1 + B * mppr
    shape = (L, N, PS, Hkv, D)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random((L, N, Hkv, 128)).astype(np.float32)
        vs = rng.random((L, N, Hkv, 128)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        v = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        ks = vs = None
    pt = (1 + np.arange(B * mppr, dtype=np.int32)).reshape(B, mppr)
    lens = np.array([3, 9, 20, 23], np.int32)
    ref = ref_kv.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), page_table=jnp.asarray(pt),
        lengths=jnp.asarray(lens),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    ours = paged_kv.PagedKVCache(
        k=_t(k), v=_t(v), page_table=_t(pt), lengths=_t(lens),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    # Row 0 moves within a page, row 1 across pages, row 2 onto itself,
    # row 3 from past its 3-page table (the garbage page 0).
    src = np.array([6, 13, 20, 27], np.int32)
    dst = np.array([4, 9, 20, 23], np.int32)
    ref = ref_kv.copy_slot(ref, jnp.asarray(src), jnp.asarray(dst))
    paged_kv.copy_slot(ours, _t(src), _t(dst))
    for name in ("k", "v", "k_scale", "v_scale"):
        r, o = getattr(ref, name), getattr(ours, name)
        if r is None:
            continue
        o = o.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if o.dtype == torch.bfloat16 else o.numpy()
        np.testing.assert_array_equal(o[:, 1:], _np(r)[:, 1:], err_msg=name)
    # The moved slots hold the sources' raw words.
    assert torch.equal(ours.k[:, pt[1, 1], 1], _t(k)[:, pt[1, 1], 5])
    if quantized:
        assert torch.equal(ours.k_scale[:, pt[0, 0], :, 4],
                           _t(ks)[:, pt[0, 0], :, 6])


# -- tree acceptance ----------------------------------------------------------

@pytest.mark.parametrize("penalty", [False, True], ids=["plain", "ring"])
def test_spec_verify_tree_greedy_equals_the_reference(penalty):
    rng = np.random.default_rng(9)
    B, K, N, V = 8, 4, 8, 96
    logits = (rng.standard_normal((B, N, V)) * 3).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = rng.integers(0, V, size=(B, K)).astype(np.int32)
    sib_tok = np.full((B, K), -1, np.int32)
    sib_node = np.full((B, K), -1, np.int32)
    for b in range(B):
        m = b % (K + 1)
        drafts[b, :m] = arg[b, :m]
        if m < K:
            if drafts[b, m] == arg[b, m]:
                drafts[b, m] = (arg[b, m] + 1) % V
            # Rows 0-2 and 4: a sibling at the first miss, the argmax on
            # even rows (used) and another token on odd ones (rejected).
            if b < 5 and b != 3:
                node = K + 1
                sib_tok[b, m] = arg[b, m] if b % 2 == 0 else (
                    arg[b, m] + 2) % V
                sib_node[b, m] = node
    max_acc = np.array([4, 4, 2, 4, 0, 3, 4, 1], np.int32)
    temps = np.zeros(B, np.float32)
    kw_ref, kw = {}, {}
    if penalty:
        ring = np.full((B, 64), V, np.int64)
        ring[:, :20] = rng.integers(0, V, size=(B, 20))
        ctx = rng.integers(10, 60, size=B).astype(np.int32)
        rp = np.full(B, 1.3, np.float32)
        kw_ref = dict(ring=jnp.asarray(ring.astype(np.int32)),
                      rp=jnp.asarray(rp), ctx_len=jnp.asarray(ctx))
        kw = dict(ring=_t(ring), rp=_t(rp), ctx_len=_t(ctx))
    want = ref_sampling.spec_verify_tree(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(sib_tok),
        jnp.asarray(sib_node), jax.random.split(jax.random.PRNGKey(0), B),
        jnp.asarray(temps), jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32),
        jnp.asarray(max_acc), **kw_ref)
    got = sampling.spec_verify_tree(
        _t(logits), _t(drafts).long(), _t(sib_tok).long(),
        _t(sib_node).long(), torch.zeros((B, 2), dtype=torch.long),
        _t(temps), torch.zeros(B, dtype=torch.long), torch.ones(B),
        _t(max_acc), **kw)
    for name, g, w in zip(("accepted", "used_sib", "correction"), got[:3],
                          want[:3]):
        np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)
    assert int(got[1].sum()) > 0
    assert got[3][:, 1].tolist() == [K + 2] * B


MC_N, MC_TV = 20000, 0.02        # as test_torch_spec.py's Monte-Carlo
PROBS = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625, 0, 0, 0])


@pytest.mark.parametrize("draft_tok,sib", [(0, 1), (1, 0)],
                         ids=["at_argmax", "elsewhere"])
def test_spec_verify_tree_sampled_distribution(draft_tok, sib):
    """One draft with a sibling at position 0 (node 2; its own
    distribution is the target's too): the emitted first token follows
    the warped distribution whichever of draft, sibling and residual
    emitted it."""
    n, V = MC_N, len(PROBS)
    lg = np.log(np.maximum(PROBS, 1e-9)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(lg, (n, 3, V)).copy())
    drafts = torch.full((n, 1), draft_tok, dtype=torch.long)
    sib_tok = torch.full((n, 1), sib, dtype=torch.long)
    sib_node = torch.full((n, 1), 2, dtype=torch.long)
    keys = torch.stack([torch.arange(n), torch.zeros(n, dtype=torch.long)],
                       dim=1)
    acc, used, corr, _ = sampling.spec_verify_tree(
        logits, drafts, sib_tok, sib_node, keys, torch.ones(n),
        torch.zeros(n, dtype=torch.long), torch.ones(n),
        torch.ones(n, dtype=torch.long))
    acc, used, corr = acc.numpy(), used.numpy(), corr.numpy()
    first = np.where(used > 0, sib, np.where(acc > 0, draft_tok, corr))
    freq = np.bincount(first, minlength=V) / n
    assert 0.5 * np.abs(freq - PROBS).sum() < MC_TV
    assert used.sum() > 0
    # A rejected draft and sibling never come back as the correction.
    rejected = (acc == 0)
    assert not np.isin(corr[rejected], [draft_tok, sib]).any()


# -- the engine's tree ticks --------------------------------------------------

class _SiblingSource(DraftSource):
    """Proposes the target's greedy continuation on the quote weights
    (its successor map) with position 1 wrong, and the right token there
    as a sibling leaf with gap 0. Counts the main-chain prefix each row
    reports through ``observe``."""

    name = "ngram"

    def __init__(self, k: int, succ: np.ndarray) -> None:
        self.k, self.succ = k, succ
        self.observed = 0

    def draft_batch(self, rows, ctxs):
        return {r: self.draft_tree_batch(rows, ctxs)[r][0] for r in rows}

    def draft_tree_batch(self, rows, ctxs):
        out = {}
        for r in rows:
            prompt, ids = ctxs[r]
            last = (list(ids) or list(prompt))[-1]
            chain = []
            for _ in range(self.k):
                last = int(self.succ[last])
                chain.append(last)
            sec = list(chain)
            gap = [9.0] * self.k
            sec[1] = chain[1]
            chain[1] = 32 + (chain[1] - 32 + 7) % 95     # wrong on purpose
            gap[1] = 0.0
            out[r] = (chain, sec, gap)
        return out

    def observe(self, row, accepted):
        self.observed += accepted


@pytest.fixture(scope="module")
def quote():
    rcfg = ref_config("tiny")
    rparams = quote_params(rcfg, jax.random.PRNGKey(3), quantized=True)
    return rcfg, rparams, params_from_numpy(jax.tree.map(np.asarray, rparams),
                                            device="cpu")


def _engine(params, spec_k=4, kv_quant=True):
    cfg = get_config("tiny")
    return TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size),
                       num_slots=2, max_seq=128, page_size=16,
                       kv_quant=kv_quant, spec_k=spec_k, spec_tree_nodes=8,
                       prefix_cache=False, prefill_chunk=0, device="cpu")


def _stub(engine, succ) -> _SiblingSource:
    src = _SiblingSource(4, succ)
    engine.scheduler._sources[:] = [src]
    return src


PROMPT, OPTS = "hi there", dict(max_tokens=40)


def test_sibling_ticks_equal_the_jax_engine(quote):
    rcfg, rparams, params = quote
    succ = successor_map(rcfg.vocab_size)
    ref = TPUEngine(rparams, rcfg, RefByteTokenizer(rcfg.vocab_size),
                    num_slots=2, max_seq=128, kv_mode="paged", page_size=16,
                    kv_quant=True, prefix_cache=False, prefill_chunk=0,
                    spec_k=4, spec_tree_nodes=8)
    engine = _engine(params)
    try:
        _stub(ref, succ)
        src = _stub(engine, succ)
        rs = RefStats()
        ref_collect(ref, RefRequest(prompt=PROMPT,
                                    options=RefOptions(**OPTS)), rs)
        stats = RequestStats()
        collect(engine, GenerateRequest(prompt=PROMPT,
                                        options=GenerateOptions(**OPTS)),
                stats)
        assert stats.context == rs.context
        snap = engine.metrics_snapshot()
        used = snap["serve_spec_accepted_total"] - src.observed
        assert used > 0, "no sibling was used"
        assert snap["serve_spec_tree_accepted_path_len"] > 2
    finally:
        ref.stop()
        engine.stop()


def test_sibling_ticks_equal_spec_off_on_a_bf16_pool(quote):
    rcfg, _, params = quote
    succ = successor_map(rcfg.vocab_size)
    on, off = _engine(params, kv_quant=False), _engine(params, spec_k=0,
                                                       kv_quant=False)
    try:
        src = _stub(on, succ)
        texts = []
        for engine in (on, off):
            stats = RequestStats()
            collect(engine, GenerateRequest(prompt=PROMPT,
                                            options=GenerateOptions(**OPTS)),
                    stats)
            texts.append(stats.context)
        assert texts[0] == texts[1]
        assert on.metrics_snapshot()["serve_spec_accepted_total"] \
            > src.observed
    finally:
        on.stop()
        off.stop()
