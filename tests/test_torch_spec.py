"""Speculative decoding in the port (linear verify) against the JAX package
on the same numpy inputs, on the CPU.

- ``NGramSource`` / ``NGramDrafter`` (utils/draft.py): the reference's
  proposals on seeded contexts, in batch and incrementally.
- ``paged_attention_verify_append``'s plain version against the
  reference's XLA function on int8 and bf16 pools, chain and tree masks,
  ragged lengths, S = 5 and the widest block S = 512: f32 within 1e-5
  (f32 reduction order only).
- ``write_decode_multi[_all_layers]``: pools bitwise equal to the
  reference's, int8 bytes and scales included, with rows whose block runs
  past their table (those positions land in the garbage page 0, whose
  contents are not compared: two rows' garbage writes may collide there
  in either order).
- ``verify_step_paged`` (both branches) for llama ``tiny`` and mixtral
  ``tiny-moe`` on f32 activations and int8 weights carried across: logits
  within the port's llama tolerances (1e-4 of the logit scale on f32
  pools, 2e-3 on int8 pools, test_torch_llama.py's reasons) and the pools
  after the call equal (f32 pools to 1e-4; int8 pools bitwise but for
  elements one int8 step apart, the 2e-3 tolerance's reason).
- ``spec_verify_batched``, greedy: accepted and correction bit-equal to
  the reference's on the same logits, with ``max_accept`` and the
  repeat-penalty ring; sampled: the emitted token's distribution equals
  the warped target distribution by a seeded Monte-Carlo (the port's keys
  are not threefry), for a draft at the argmax and one elsewhere.
- The engine, greedy, on the reference's quote weights carried across
  (tiny, int8 pool): the port's spec-on stream equals the JAX engine's
  spec-on stream (tree default and linear); on a bf16 pool spec on equals
  spec off bitwise, in both attention orderings; the near-budget rows
  case and the repeat-penalty case; the settings (tree-node snapping,
  ``SERVE_DRAFT`` refused with ``SERVE_SPEC``) and the ``serve_spec_*``
  key set of ``/metrics``.
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
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu.utils import draft as ref_draft
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models import sampling
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import (params_from_numpy,
                                                   tensor_from_numpy)
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.ops.paged_attention import (
    paged_attention_verify_append, paged_attention_verify_append_reference)
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import (TorchEngine,
                                                 build_engine_from_env)
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils import draft

ref_pa = importlib.import_module("p2p_llm_chat_tpu.ops.paged_attention")
torch.set_num_threads(2)
pytestmark = pytest.mark.model

PS = 8


def _np(x):
    return np.asarray(x)


def _t(a):
    return tensor_from_numpy(a, device="cpu")


# -- draft sources ------------------------------------------------------------

def test_ngram_proposals_equal_the_reference():
    rng = np.random.default_rng(0)
    proposed = 0
    for n in (2, 3):
        for k in (1, 4):
            rows = list(range(6))
            ctxs = {r: [int(t) for t in rng.integers(0, 3, size=12 + 3 * r)]
                    for r in rows}
            ours, ref = draft.NGramSource(k, n=n), ref_draft.NGramSource(k,
                                                                         n=n)
            for r in rows[:3]:             # admitted; the rest bind late
                ours.admit(r, ctxs[r][:4])
                ref.admit(r, ctxs[r][:4])
                for t in ctxs[r][4:]:
                    ours.append(r, t)
                    ref.append(r, t)
            pairs = {r: (ctxs[r][:4], ctxs[r][4:]) for r in rows}
            got = ours.draft_batch(rows, pairs)
            assert got == ref.draft_batch(rows, pairs)
            assert ours.draft_tree_batch(rows, pairs) == \
                ref.draft_tree_batch(rows, pairs)
            for r in rows:
                whole = draft.NGramDrafter(ctxs[r], k, n=n).draft()
                assert got.get(r, []) == whole
                assert whole == ref_draft.NGramDrafter(ctxs[r], k,
                                                       n=n).draft()
            proposed += sum(map(bool, got.values()))
    assert proposed > 10


# -- verify attention and the multi-position writes ---------------------------

def _pool_pair(quantized: bool, rng, L=2, Hkv=2, D=16, B=3, mppr=6,
               lengths=(20, 37, 3)):
    """The same random pool as a reference PagedKVCache and a port one:
    rows own disjoint pages 1.., page 0 is the garbage page; int8 values
    with f32 scales, or bf16 values."""
    N = 1 + B * mppr
    shape = (L, N, PS, Hkv, D)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random((L, N, Hkv, 128)) / 64).astype(np.float32)
        vs = (rng.random((L, N, Hkv, 128)) / 64).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        v = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        ks = vs = None
    pt = (1 + np.arange(B * mppr, dtype=np.int32)).reshape(B, mppr)
    lens = np.asarray(lengths, np.int32)
    ref = ref_kv.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), page_table=jnp.asarray(pt),
        lengths=jnp.asarray(lens),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    ours = paged_kv.PagedKVCache(
        k=_t(k), v=_t(v), page_table=_t(pt), lengths=_t(lens),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    return ref, ours


def _random_anc(rng, B, S):
    """Per-row ancestor matrices of random trees (node i's parent is a
    random earlier node; node 0 the root; self included)."""
    anc = np.zeros((B, S, S), bool)
    for b in range(B):
        for i in range(S):
            anc[b, i, i] = True
            if i:
                anc[b, i] |= anc[b, rng.integers(0, i)]
    return anc


@pytest.mark.parametrize("quantized,tree,S", [
    pytest.param(True, False, 5, id="int8-chain"),
    pytest.param(True, True, 5, id="int8-tree"),
    pytest.param(False, False, 5, id="bf16-chain"),
    pytest.param(False, True, 5, id="bf16-tree"),
    # The widest block (a drafter's 512-position catch-up feed).
    pytest.param(True, False, 512, id="int8-chain-S512"),
    pytest.param(False, False, 512, id="bf16-chain-S512"),
])
def test_verify_attention_plain_equals_the_reference(quantized, tree, S):
    rng = np.random.default_rng(3 + quantized + 2 * tree + (S > 5) * 10)
    B, Hq, Hkv, D = 3, 4, 2, 16
    ref, ours = _pool_pair(quantized, rng)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kb = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vb = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    mask = _random_anc(rng, B, S) if tree else None
    for layer in (0, 1):
        want = ref_pa.paged_attention_verify_append(
            jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), ref,
            ref.lengths, layer, pages=5,
            block_mask=None if mask is None else jnp.asarray(mask))
        args = (_t(q), _t(kb), _t(vb), ours, ours.lengths, layer)
        kw = dict(pages=5, block_mask=None if mask is None else _t(mask))
        got = paged_attention_verify_append_reference(*args, **kw)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"layer {layer}")
        # On CPU tensors the wrapper is the plain version and launches
        # nothing.
        before = paged_attention_verify_append.launches
        assert torch.equal(paged_attention_verify_append(*args, **kw), got)
        assert paged_attention_verify_append.launches == before


def _pools_equal(ref, ours, skip_page0: bool = True):
    lo = 1 if skip_page0 else 0
    for name in ("k", "v", "k_scale", "v_scale"):
        r, o = getattr(ref, name), getattr(ours, name)
        if r is None:
            assert o is None
            continue
        r = _np(r)
        o = o.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if o.dtype == torch.bfloat16 else o.numpy()
        np.testing.assert_array_equal(o[:, lo:], r[:, lo:], err_msg=name)


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_multi_position_writes_equal_the_reference(quantized):
    """Row 1's block of 6 crosses a page boundary; row 2's starts 3
    slots before the end of its 6-page table, so 3 positions land in
    page 0."""
    rng = np.random.default_rng(5)
    lengths = (20, 15, 6 * PS - 3)
    ref, ours = _pool_pair(quantized, rng, lengths=lengths)
    L, B, S, Hkv, D = 2, 3, 6, 2, 16
    k_all = rng.standard_normal((L, B, S, Hkv, D)).astype(ml_dtypes.bfloat16)
    v_all = rng.standard_normal((L, B, S, Hkv, D)).astype(ml_dtypes.bfloat16)
    ref = ref_kv.write_decode_multi_all_layers(ref, jnp.asarray(k_all),
                                               jnp.asarray(v_all))
    paged_kv.write_decode_multi_all_layers(ours, _t(k_all), _t(v_all))
    _pools_equal(ref, ours)
    ref = ref_kv.write_decode_multi(ref, 1, jnp.asarray(k_all[0]),
                                    jnp.asarray(v_all[0]))
    paged_kv.write_decode_multi(ours, 1, _t(k_all[0]), _t(v_all[0]))
    _pools_equal(ref, ours)
    np.testing.assert_array_equal(ours.lengths.numpy(), lengths)


# -- the verify forward -------------------------------------------------------

class _Pools:
    """The same prompts prefilled into a reference pool and a port pool
    (f32 activations; an f32 or int8 pool)."""

    def __init__(self, config: str, params, prompts, quantized: bool,
                 mppr: int = 6):
        self.rcfg, self.cfg = ref_config(config), get_config(config)
        self.ref_fam = ref_mixtral if self.rcfg.is_moe else ref_llama
        self.fam = family_for(self.cfg)
        self.rparams = params
        self.params = params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
        B, S = len(prompts), 16
        toks = np.zeros((B, S), np.int32)
        lens = np.array([len(p) for p in prompts], np.int32)
        for b, p in enumerate(prompts):
            toks[b, :len(p)] = p
        tables = (1 + np.arange(B * mppr, dtype=np.int32)).reshape(B, mppr)
        N = B * mppr + 1
        dt = params["embed"].dtype
        small = KVCache.create(self.rcfg, B, S, dtype=dt)
        _, small = self.ref_fam.prefill(params, self.rcfg, jnp.asarray(toks),
                                        jnp.asarray(lens), small,
                                        last_only=True)
        rc = ref_kv.PagedKVCache.create(self.rcfg, B, N, PS,
                                        max_pages_per_row=mppr, dtype=dt,
                                        quantized=quantized)
        self.ref_cache = ref_kv.write_prefill_batch(
            rc, small.k, small.v, jnp.arange(B), jnp.asarray(lens),
            jnp.asarray(tables))
        _, k_all, v_all = self.fam.prefill(
            self.params, self.cfg, torch.from_numpy(toks).long(),
            torch.from_numpy(lens), last_only=True)
        self.cache = paged_kv.PagedKVCache.create(
            self.cfg, B, N, PS, max_pages_per_row=mppr,
            dtype=self.params["embed"].dtype, quantized=quantized,
            device="cpu")
        paged_kv.write_prefill_batch(self.cache, k_all, v_all,
                                     torch.arange(B), torch.from_numpy(lens),
                                     torch.from_numpy(tables))

    def check_pools(self, tol: float) -> None:
        np.testing.assert_array_equal(self.cache.lengths.numpy(),
                                      _np(self.ref_cache.lengths))
        live = self.cache.page_table.numpy().reshape(-1)
        for name in ("k", "v"):
            r = _np(getattr(self.ref_cache, name))[:, live].astype(np.float32)
            o = getattr(self.cache, name)[:, live].float().numpy()
            if self.cache.quantized:
                s = "k_scale" if name == "k" else "v_scale"
                rs = _np(getattr(self.ref_cache, s))[:, live][..., :PS]
                os_ = getattr(self.cache, s)[:, live][..., :PS].numpy()
                np.testing.assert_allclose(os_, rs, rtol=tol, atol=0)
                off = np.abs(o - r)
                assert off.max() <= 1 and (off > 0).mean() < 0.01, name
            else:
                np.testing.assert_allclose(o, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("config,impl,quantized,tol", [
    ("tiny", "gather", True, 2e-3),
    ("tiny", "gather", False, 1e-4),
    ("tiny", "kernel", False, 1e-4),
    ("tiny-moe", "gather", True, 2e-3)])
def test_verify_step_paged_equals_the_reference(config, impl, quantized, tol,
                                                monkeypatch):
    rcfg = ref_config(config)
    init = ref_mixtral if rcfg.is_moe else ref_llama
    params = init.init_params_quantized(rcfg, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(3, 500, size=n)) for n in (5, 12, 9)]
    pools = _Pools(config, params, prompts, quantized)
    # pages cover lengths + S for the write-then-attend branch.
    toks = rng.integers(3, 500, size=(3, 5)).astype(np.int32)
    pages = 3
    monkeypatch.setattr(ref_pa, "_DEFAULT_IMPL", impl)
    want, pools.ref_cache = pools.ref_fam.verify_step_paged(
        params, rcfg, jnp.asarray(toks), pools.ref_cache, pages=pages,
        interpret=True)
    got, _ = pools.fam.verify_step_paged(
        pools.params, pools.cfg, torch.from_numpy(toks).long(), pools.cache,
        pages=pages, impl=impl)
    want = _np(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * scale)
    pools.check_pools(tol)


# -- acceptance ---------------------------------------------------------------

def _ref_keys(B: int):
    return jax.random.split(jax.random.PRNGKey(0), B)


def _ring(rng, B, V, fill=20):
    ring = np.full((B, 64), V, np.int64)
    ring[:, :fill] = rng.integers(0, V, size=(B, fill))
    return ring


@pytest.mark.parametrize("penalty", [False, True], ids=["plain", "ring"])
def test_spec_verify_batched_greedy_equals_the_reference(penalty):
    rng = np.random.default_rng(7)
    B, K, V = 8, 4, 96
    logits = (rng.standard_normal((B, K + 1, V)) * 3).astype(np.float32)
    arg = logits.argmax(-1)
    # Rows whose drafts match the argmax for the first b % (K + 1)
    # positions, then miss.
    drafts = rng.integers(0, V, size=(B, K)).astype(np.int32)
    for b in range(B):
        m = b % (K + 1)
        drafts[b, :m] = arg[b, :m]
        if m < K and drafts[b, m] == arg[b, m]:
            drafts[b, m] = (arg[b, m] + 1) % V
    max_acc = np.array([4, 4, 2, 4, 0, 3, 4, 1], np.int32)
    temps = np.zeros(B, np.float32)
    kw_ref, kw = {}, {}
    if penalty:
        ring = _ring(rng, B, V)
        ctx = rng.integers(10, 60, size=B).astype(np.int32)
        rp = np.full(B, 1.3, np.float32)
        kw_ref = dict(ring=jnp.asarray(ring.astype(np.int32)),
                      rp=jnp.asarray(rp), ctx_len=jnp.asarray(ctx))
        kw = dict(ring=_t(ring), rp=_t(rp), ctx_len=_t(ctx))
    acc_r, corr_r, _ = ref_sampling.spec_verify_batched(
        jnp.asarray(logits), jnp.asarray(drafts), _ref_keys(B),
        jnp.asarray(temps), jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32),
        jnp.asarray(max_acc), **kw_ref)
    acc, corr, keys = sampling.spec_verify_batched(
        _t(logits), _t(drafts).long(), torch.zeros((B, 2), dtype=torch.long),
        _t(temps), torch.zeros(B, dtype=torch.long), torch.ones(B),
        _t(max_acc), **kw)
    np.testing.assert_array_equal(acc.numpy(), _np(acc_r))
    np.testing.assert_array_equal(corr.numpy(), _np(corr_r))
    assert 0 < int(acc.sum()) and (acc.numpy() <= max_acc).all()
    assert keys[:, 1].tolist() == [K + 1] * B


# Monte-Carlo of the emitted first token: n rows of one distribution, each
# row its own key. The total-variation distance between the empirical
# and the warped distribution over 8 ids is below 0.02 (its expectation
# at n = 20000 is ~0.006), and the acceptance rate within 0.02 of
# p(draft).
MC_N, MC_TV = 20000, 0.02
PROBS = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625, 0, 0, 0])


def _tv(samples: np.ndarray, probs: np.ndarray) -> float:
    freq = np.bincount(samples, minlength=len(probs)) / len(samples)
    return 0.5 * float(np.abs(freq - probs).sum())


@pytest.mark.parametrize("draft_tok", [0, 1], ids=["at_argmax",
                                                   "elsewhere"])
def test_spec_verify_batched_sampled_distribution(draft_tok):
    n, V = MC_N, len(PROBS)
    lg = np.log(np.maximum(PROBS, 1e-9)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(lg, (n, 2, V)).copy())
    drafts = torch.full((n, 1), draft_tok, dtype=torch.long)
    keys = torch.stack([torch.arange(n), torch.zeros(n, dtype=torch.long)],
                       dim=1)
    acc, corr, _ = sampling.spec_verify_batched(
        logits, drafts, keys, torch.ones(n), torch.zeros(n, dtype=torch.long),
        torch.ones(n), torch.ones(n, dtype=torch.long))
    acc, corr = acc.numpy(), corr.numpy()
    first = np.where(acc > 0, draft_tok, corr)
    assert _tv(first, PROBS) < MC_TV
    assert abs(acc.mean() - PROBS[draft_tok]) < 0.02
    # The correction after a rejection never repeats the rejected draft.
    assert not (corr[acc == 0] == draft_tok).any()


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def quote():
    rcfg = ref_config("tiny")
    rparams = quote_params(rcfg, jax.random.PRNGKey(3), quantized=True)
    return rcfg, rparams, params_from_numpy(jax.tree.map(np.asarray, rparams),
                                            device="cpu")


def _engine(params, spec_k=4, nodes=8, kv_quant=True, **kw):
    cfg = get_config("tiny")
    args = dict(num_slots=2, max_seq=128, page_size=16, kv_quant=kv_quant,
                spec_k=spec_k, spec_tree_nodes=nodes, prefix_cache=False,
                prefill_chunk=0, kv_mode="paged", device="cpu")
    args.update(kw)
    return TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), **args)


def _ref_engine(rcfg, rparams, spec_k=4, nodes=8, **kw):
    args = dict(num_slots=2, max_seq=128, kv_mode="paged", page_size=16,
                kv_quant=True, prefix_cache=False, prefill_chunk=0,
                spec_k=spec_k, spec_tree_nodes=nodes)
    args.update(kw)
    return TPUEngine(rparams, rcfg, RefByteTokenizer(rcfg.vocab_size), **args)


def _context(engine, prompt, **opts):
    stats = RequestStats()
    collect(engine, GenerateRequest(prompt=prompt,
                                    options=GenerateOptions(**opts)), stats)
    return stats.context


def _ref_context(engine, prompt, **opts):
    stats = RefStats()
    ref_collect(engine, RefRequest(prompt=prompt, options=RefOptions(**opts)),
                stats)
    return stats.context


PROMPTS = ("abcabc hello hello", "the quick brown fox")


@pytest.mark.parametrize("nodes", [8, 0], ids=["tree", "linear"])
def test_spec_greedy_context_equals_the_jax_engine(quote, nodes):
    rcfg, rparams, params = quote
    ref = _ref_engine(rcfg, rparams, nodes=nodes)
    engine = _engine(params, nodes=nodes)
    try:
        for prompt in PROMPTS:
            got = _context(engine, prompt, max_tokens=40)
            assert got == _ref_context(ref, prompt, max_tokens=40), prompt
        snap = engine.metrics_snapshot()
        assert snap["serve_spec_accepted_total"] > 0
        assert snap["serve_spec_accepted_per_dispatch"] > 1
        assert engine.scheduler.spec_tree_nodes == nodes
    finally:
        ref.stop()
        engine.stop()


@pytest.mark.parametrize("impl,nodes", [("gather", 8), ("gather", 0),
                                        ("kernel", 0)])
def test_spec_on_equals_spec_off_on_a_bf16_pool(quote, impl, nodes):
    _, _, params = quote
    on = _engine(params, nodes=nodes, kv_quant=False, attn_impl=impl)
    off = _engine(params, spec_k=0, kv_quant=False, attn_impl=impl)
    try:
        for prompt in PROMPTS:
            assert _context(on, prompt, max_tokens=48) == _context(
                off, prompt, max_tokens=48), prompt
        assert on.metrics_snapshot()["serve_spec_accepted_total"] > 0
    finally:
        on.stop()
        off.stop()


def test_spec_near_budget_equals_spec_off_and_the_jax_engine(quote):
    """max_acc caps acceptance near the context budget: the stream is
    truncated as the plain engine's is, and equals the JAX engine's."""
    rcfg, rparams, params = quote
    on = _engine(params, max_seq=32)
    off = _engine(params, spec_k=0, max_seq=32)
    ref = _ref_engine(rcfg, rparams, max_seq=32)
    try:
        prompt = "xyxy xyxy xyxy"
        got = _context(on, prompt, max_tokens=64)
        assert got == _context(off, prompt, max_tokens=64)
        assert got == _ref_context(ref, prompt, max_tokens=64)
        assert len(got) <= 32
    finally:
        for e in (on, off, ref):
            e.stop()


def test_spec_repeat_penalty_equals_the_jax_engine(quote):
    rcfg, rparams, params = quote
    ref = _ref_engine(rcfg, rparams, nodes=0)
    engine = _engine(params, nodes=0)
    try:
        prompt = "the quick brown fox jumps over the lazy dog " * 2
        opts = dict(max_tokens=40, repeat_penalty=1.3)
        assert _context(engine, prompt, **opts) == _ref_context(
            ref, prompt, **opts)
    finally:
        ref.stop()
        engine.stop()


# -- settings and metrics -----------------------------------------------------

@pytest.mark.parametrize("nodes", [0, 5, 6, 8, 16])
def test_tree_nodes_snap_as_the_reference(quote, nodes):
    rcfg, rparams, params = quote
    ref = _ref_engine(rcfg, rparams, nodes=nodes)
    engine = _engine(params, nodes=nodes)
    try:
        assert engine.scheduler.spec_tree_nodes == \
            ref.scheduler.spec_tree_nodes
    finally:
        ref.stop()
        engine.stop()


def test_env_settings(monkeypatch):
    for k, v in dict(SERVE_DEVICE="cpu", SERVE_WARMUP="0",
                     MODEL_CONFIG="tiny", SERVE_QUANT="int8",
                     SERVE_SPEC="4").items():
        monkeypatch.setenv(k, v)
    engine = build_engine_from_env()
    try:
        assert engine.scheduler.spec_k == 4
        assert engine.scheduler.spec_tree_nodes == 8
    finally:
        engine.stop()
    monkeypatch.setenv("SERVE_SPEC_TREE_NODES", "0")
    engine = build_engine_from_env()
    try:
        assert engine.scheduler.spec_tree_nodes == 0
    finally:
        engine.stop()
    # SERVE_DRAFT with speculation makes the draft model resident as the
    # second source (serve/draft_model.py); without speculation it is
    # ignored with a warning, as in the reference.
    monkeypatch.setenv("SERVE_DRAFT", "tiny")
    engine = build_engine_from_env()
    try:
        assert engine.drafter is not None
        assert [s.name for s in engine.scheduler._sources] == ["ngram",
                                                               "model"]
    finally:
        engine.stop()
    monkeypatch.setenv("SERVE_SPEC", "0")
    engine = build_engine_from_env()
    assert engine.drafter is None
    engine.stop()


def test_spec_metrics_key_set_equals_the_reference(quote):
    rcfg, rparams, params = quote
    ref = _ref_engine(rcfg, rparams)
    engine = _engine(params)
    try:
        keys = []
        for eng, ctx in ((ref, _ref_context), (engine, _context)):
            ctx(eng, PROMPTS[0], max_tokens=24)
            keys.append({k for k in eng.metrics_snapshot()
                         if k.startswith("serve_spec_")})
        assert keys[0] == keys[1]
        assert 'serve_spec_accepted_per_dispatch{source="ngram"}' in keys[1]
        assert "serve_spec_tree_nodes_total" in keys[1]
    finally:
        ref.stop()
        engine.stop()
