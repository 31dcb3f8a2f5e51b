"""The port's KV tier (serve/kv_tier.py, the page-set ops of ops/paged_kv.py
and the scheduler's retain / park / wake) against the reference, on the
CPU.

- The policy copies: ``head_key``, ``cost_evict`` and ``KVTier``'s
  lookup, claim, budget and cap decisions equal the reference's on the
  same inputs (exact: integer and key results).
- ``gather_pages`` / ``scatter_pages``: the same pool words as the
  reference's on the same pool, int8 (values and head-major scales) and
  bf16, bitwise; the scatter writes the pool tensors in place (their
  ``data_ptr`` is unchanged, which the captured decode graphs need).
- ``verify_step_paged(last_idx=...)`` (the wake's forward, through the
  plain verify version) equals the reference's at S = 16 and 256 on an
  int8 pool: logits within 2e-3 of the logit scale (test_torch_spec.py's
  int8-pool tolerance and its reason), and the last-position logits equal
  the full forward's row bitwise.
- Park -> wake on the engine (tiny, paged int8, page size 64): the greedy
  stream of a session parked to the host and woken is BYTE-identical to
  the same session woken resident, and to the never-retained cold run;
  a bare context continuation wakes by the token-head index.
- On the reference's quote weights (tiny, int8 pool), the port's woken
  greedy stream equals the JAX engine's, and both wake the same requests.

Slow (the reference's own split): a bf16 pool, a prefix-cache
composition, turn-by-turn rotation, eviction under a tiny host budget,
and pool pressure parking residents for new admissions.
"""

import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import KVCache
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.ops import paged_kv as ref_kv
from p2p_llm_chat_tpu.serve import kv_tier as ref_tier
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import (params_from_numpy,
                                                   tensor_from_numpy)
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.serve import kv_tier
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

RCFG = ref_config("tiny")
CFG = get_config("tiny")
PROMPT1 = "hello there, how are you doing today my good friend?"
PROMPT2 = " tell me one more thing before we finish?"
ANON = "a different anonymous conversation starter!"


@pytest.fixture(scope="module")
def params():
    """The reference test's weights (tiny, f32), carried across."""
    rparams = ref_llama.init_params(RCFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, rparams),
                             device="cpu")


def run(engine, prompt, session="", max_tokens=8, ctx=()):
    stats = RequestStats()
    req = GenerateRequest(prompt=prompt, session=session, context=tuple(ctx),
                          options=GenerateOptions(max_tokens=max_tokens,
                                                  temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


def make_engine(params, kv_quant=True, prefix=False, pages=None,
                host_gb=1.0, idle_s=1e9, slots=2, cfg=CFG):
    eng = TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size),
                      num_slots=slots, max_seq=256, page_size=64,
                      num_pages=pages, prefix_cache=prefix,
                      kv_quant=kv_quant, kv_host_gb=host_gb,
                      kv_idle_s=idle_s, kv_mode="paged", device="cpu")
    eng.scheduler.warmup((64, 128), eng.prefix_texts)
    return eng


def wait_for(fn, timeout=10.0, msg="condition"):
    """Retention runs on the scheduler thread just after the consumer's
    last delta: poll."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def force_park(sched, want=1):
    """Idle threshold to 0 until the loop's own sweep has parked (only
    the loop may touch the pool)."""
    sched._tier.idle_s = 0.0
    wait_for(lambda: sched._tier.counts()[1] >= want, msg="park")
    sched._tier.idle_s = 1e9


def two_turns(eng, session="sess", park=False):
    t1, s1 = run(eng, PROMPT1, session)
    wait_for(lambda: eng.scheduler._tier.counts()[0] >= 1,
             msg="turn-1 retention")
    if park:
        force_park(eng.scheduler)
        assert eng.scheduler._tier.counts() == (0, 1)
    t2, _ = run(eng, PROMPT2, session, ctx=s1.context)
    return t1, t2


# -- the policy copies ---------------------------------------------------------

@pytest.mark.parametrize("n", [0, 31, 32, 33, 100])
def test_head_key_equals_the_reference(n):
    ids = list(np.random.default_rng(n).integers(0, 50000, size=n))
    assert kv_tier.head_key(ids) == ref_tier.head_key(ids)


@pytest.mark.parametrize("over", [0, 10, 1000, 1005, 2500, 10 ** 6])
def test_cost_evict_equals_the_reference(over):
    now = 1000.0
    items = [("small-stale", 10, now - 100.0), ("big-stale", 1000, now - 100),
             ("big-warm", 1000, now - 0.1), ("small-warm", 10, now - 0.1),
             ("fresh", 500, now)]
    assert (kv_tier.cost_evict(items, over, now=now)
            == ref_tier.cost_evict(items, over, now=now))


def _pair_sessions(rng_seed: int):
    """The same parked / resident sessions for both tiers."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(6):
        n = int(rng.integers(20, 60))
        toks = tuple(int(t) for t in rng.integers(0, 300, size=n))
        if i % 3 == 0:
            toks = tuple(range(n))       # shared heads collide on purpose
        nbytes = int(rng.integers(10, 200))
        parked = bool(i % 2)
        out.append((f"sid:{i}", toks, nbytes, parked,
                    1000.0 - float(rng.integers(0, 100))))
    return out


def _both(sessions, budget, cap):
    ref = ref_tier.KVTier(host_bytes=budget, max_sessions=cap)
    port = kv_tier.KVTier(host_bytes=budget, max_sessions=cap)
    for key, toks, nbytes, parked, used in sessions:
        ref.insert(ref_tier.SessionKV(
            key=key, tokens=toks, length=len(toks),
            pages=None if parked else [1],
            host=((np.zeros(2),), 1) if parked else None, nbytes=nbytes,
            last_used=used))
        port.insert(kv_tier.SessionKV(
            key=key, tokens=toks, length=len(toks),
            pages=None if parked else [1],
            host=((torch.zeros(2),), 1) if parked else None, nbytes=nbytes,
            last_used=used))
    return ref, port


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tier_policy_equals_the_reference(seed):
    sessions = _pair_sessions(seed)
    ref, port = _both(sessions, budget=300, cap=4)
    keys = lambda xs: [s.key for s in xs]
    assert ref.counts() == port.counts()
    assert ref.stats() == port.stats()
    assert keys(ref.host_victims()) == keys(port.host_victims())
    assert keys(ref.overflow_victims()) == keys(port.overflow_victims())
    assert (keys(ref.park_candidates(now=1000.0))
            == keys(port.park_candidates(now=1000.0)))
    assert (keys(ref.park_candidates(force=True))
            == keys(port.park_candidates(force=True)))
    # Lookups: explicit key extension, derived head, exact length (no
    # suffix), diverged history (dropped), unknown.
    for key, toks, *_ in sessions:
        for probe_key, prompt in ((key, list(toks) + [7]),
                                  ("", list(toks) + [7, 8]),
                                  (key, list(toks)),
                                  (key, list(toks[:-1]) + [999, 1]),
                                  ("sid:none", [1, 2, 3])):
            a = ref.lookup(probe_key, prompt)
            b = port.lookup(probe_key, prompt)
            assert (a and a.key) == (b and b.key), (probe_key, prompt)
    assert ref.counts() == port.counts()
    assert ref.stats() == port.stats()
    assert sorted(ref.sessions_meta()) == sorted(port.sessions_meta())
    for key, toks, *_ in sessions:
        a = ref.claim(key, list(toks) + [5])
        b = port.claim(key, list(toks) + [5])
        assert (a and a.key) == (b and b.key)
    assert ref.counts() == port.counts()


# -- page-set gather / scatter --------------------------------------------------

def _pools(quantized: bool, seed: int = 0):
    """The same random pool contents in a reference pool and a port pool
    (tiny geometry, 12 pages of 4 slots)."""
    L, Hkv, D = RCFG.num_layers, RCFG.num_kv_heads, RCFG.head_dim
    N, ps = 12, 4
    rng = np.random.default_rng(seed)
    rc = ref_kv.PagedKVCache.create(RCFG, 2, N, ps, quantized=quantized,
                                    dtype=jnp.bfloat16)
    pc = paged_kv.PagedKVCache.create(CFG, 2, N, ps, quantized=quantized,
                                      dtype=torch.bfloat16, device="cpu")
    if quantized:
        k = rng.integers(-127, 128, size=(L, N, ps, Hkv, D), dtype=np.int8)
        v = rng.integers(-127, 128, size=(L, N, ps, Hkv, D), dtype=np.int8)
        ks = rng.random(rc.k_scale.shape, dtype=np.float32)
        vs = rng.random(rc.v_scale.shape, dtype=np.float32)
        rc = rc._replace(k=jnp.asarray(k), v=jnp.asarray(v),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        for name, a in (("k", k), ("v", v), ("k_scale", ks),
                        ("v_scale", vs)):
            getattr(pc, name).copy_(torch.from_numpy(a))
    else:
        words = rng.integers(0, 2 ** 16, size=(2, L, N, ps, Hkv, D),
                             dtype=np.uint16) & 0xBFFF  # finite bf16s
        k, v = (w.view(ml_dtypes.bfloat16) for w in words)
        rc = rc._replace(k=jnp.asarray(k), v=jnp.asarray(v))
        pc.k.copy_(tensor_from_numpy(k, device="cpu"))
        pc.v.copy_(tensor_from_numpy(v, device="cpu"))
    return rc, pc


def _bits(a) -> np.ndarray:
    """The raw words of a jax / numpy array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
def test_gather_scatter_equal_the_reference(quantized):
    rc, pc = _pools(quantized)
    pages = [7, 2, 9, 0]            # three pages, padded to 4 with page 0
    want = ref_kv.gather_pages(rc, jnp.asarray(pages, jnp.int32))
    got = paged_kv.gather_pages(pc, torch.tensor(pages))
    assert len(got) == 4
    for a, b in zip(want, got):
        assert (a is None) == (b is None) == (not quantized and a is None)
        if a is not None:
            np.testing.assert_array_equal(_bits(b), _bits(a))
    # Scatter the payload into other pages of fresh pools.
    rc2, pc2 = _pools(quantized, seed=1)
    ptrs = {n: getattr(pc2, n).data_ptr()
            for n in ("k", "v", "k_scale", "v_scale")
            if getattr(pc2, n) is not None}
    dst = [3, 11, 5, 0]
    rc2 = ref_kv.scatter_pages(rc2, jnp.asarray(dst, jnp.int32), *want)
    paged_kv.scatter_pages(pc2, torch.tensor(dst), *got)
    assert {n: getattr(pc2, n).data_ptr() for n in ptrs} == ptrs
    live = [p for p in range(12) if p != 0]   # page 0 holds garbage
    for name in ptrs:
        np.testing.assert_array_equal(
            _bits(getattr(pc2, name))[:, live],
            _bits(getattr(rc2, name))[:, live])
    np.testing.assert_array_equal(_bits(pc2.k)[:, dst[:3]],
                                  _bits(got[0])[:, :3])


def test_row_ops_write_in_place():
    _, pc = _pools(True)
    ptrs = (pc.page_table.data_ptr(), pc.lengths.data_ptr())
    pc.lengths[1] = 9
    paged_kv.set_row_table(pc, 1, torch.tensor([4, 5] + [0] * 10))
    assert pc.page_table[1, :3].tolist() == [4, 5, 0]
    assert int(pc.lengths[1]) == 0
    pc.lengths[1] = 7
    paged_kv.zero_row(pc, 1)
    assert int(pc.page_table[1].abs().sum()) == 0 and int(pc.lengths[1]) == 0
    assert (pc.page_table.data_ptr(), pc.lengths.data_ptr()) == ptrs


# -- the wake's forward ---------------------------------------------------------

@pytest.mark.parametrize("config,S", [("tiny", 16), ("tiny", 256),
                                      ("tiny-moe", 16)])
def test_verify_last_idx_equals_the_reference(config, S):
    """A wake-shaped forward: R = 2 sessions at lengths 12 and 40 on an
    int8 pool, a suffix block of S positions (right-padded), logits at
    each row's last suffix position."""
    rcfg, cfg = ref_config(config), get_config(config)
    ref_fam = ref_mixtral if rcfg.is_moe else ref_llama
    rparams = ref_fam.init_params_quantized(rcfg, jax.random.PRNGKey(0),
                                            dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams),
                                device="cpu")
    fam = family_for(cfg)
    rng = np.random.default_rng(S)
    lens = np.array([12, 40], np.int32)
    B, P, ps = 2, 64, 16
    toks = np.zeros((B, P), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(3, 500, size=n)
    mppr = -(-(P + S) // ps)
    tables = (1 + np.arange(B * mppr, dtype=np.int32)).reshape(B, mppr)
    N = B * mppr + 1
    small = KVCache.create(rcfg, B, P, dtype=jnp.float32)
    _, small = ref_fam.prefill(rparams, rcfg, jnp.asarray(toks),
                               jnp.asarray(lens), small, last_only=True)
    rc = ref_kv.write_prefill_batch(
        ref_kv.PagedKVCache.create(rcfg, B, N, ps, max_pages_per_row=mppr,
                                   dtype=jnp.float32, quantized=True),
        small.k, small.v, jnp.arange(B), jnp.asarray(lens),
        jnp.asarray(tables))
    _, k_all, v_all = fam.prefill(tparams, cfg, torch.from_numpy(toks).long(),
                                  torch.from_numpy(lens), last_only=True)
    pc = paged_kv.PagedKVCache.create(cfg, B, N, ps, max_pages_per_row=mppr,
                                      dtype=torch.float32, quantized=True,
                                      device="cpu")
    paged_kv.write_prefill_batch(pc, k_all, v_all, torch.arange(B),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(tables))
    suf = np.array([S, max(1, S // 3)], np.int32)
    block = np.zeros((B, S), np.int32)
    for b in range(B):
        block[b, :suf[b]] = rng.integers(3, 500, size=suf[b])
    last = suf - 1
    want, _ = ref_fam.verify_step_paged(
        rparams, rcfg, jnp.asarray(block), rc, pages=mppr, interpret=True,
        last_idx=jnp.asarray(last))
    full = paged_kv.PagedKVCache(**{n: getattr(pc, n).clone()
                                    for n in ("k", "v", "page_table",
                                              "lengths", "k_scale",
                                              "v_scale")})
    got, _ = fam.verify_step_paged(tparams, cfg,
                                   torch.from_numpy(block).long(), pc,
                                   pages=mppr, last_idx=torch.from_numpy(last))
    want = np.asarray(want)
    assert got.shape == want.shape == (B, 1, cfg.vocab_size)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                               atol=2e-3 * scale)
    every, _ = fam.verify_step_paged(tparams, cfg,
                                     torch.from_numpy(block).long(), full,
                                     pages=mppr)
    assert torch.equal(every[torch.arange(B), torch.from_numpy(last)].view(
        B, 1, -1), got)


# -- park / wake on the engine --------------------------------------------------

def test_park_wake_bit_identity_paged_int8(params):
    """A session parked to host tensors and woken resumes with greedy
    output BYTE-identical to the same session woken resident (int8 pool,
    scales included) and to the never-retained cold run; the tier's
    series move as the reference's."""
    cold = TorchEngine(params, CFG, ByteTokenizer(CFG.vocab_size),
                       num_slots=2, max_seq=256, page_size=64,
                       prefix_cache=False, kv_quant=True, kv_mode="paged",
                       device="cpu")
    try:
        c1, cs = run(cold, PROMPT1, "sess")
        c2, _ = run(cold, PROMPT2, "sess", ctx=cs.context)
        assert cold.scheduler.session_list() is None
    finally:
        cold.stop()
    a = make_engine(params)
    try:
        a1, a2 = two_turns(a, park=False)        # resident wake
        snap = a.scheduler.metrics_snapshot()
        assert snap["kv_waked_total"] == 1
        assert snap["kv_wake_tokens_saved_total"] > 0
        assert snap["kv_wake_p50_ms"] > 0
        for k in ("kv_resident_sessions", "kv_parked_sessions",
                  "kv_open_sessions", "kv_host_bytes", "kv_parked_total",
                  "kv_wake_cold_total", "kv_evicted_total",
                  "kv_pages_freed_total", "kv_wake_p95_ms"):
            assert k in snap, k
        # A bare context continuation (no session id) wakes by the
        # token-head index.
        _, ds = run(a, ANON * 2, session="")
        wait_for(lambda: a.scheduler._tier.counts()[0] >= 2,
                 msg="derived-head retention")
        run(a, PROMPT2, session="", ctx=ds.context)
        assert a.scheduler.metrics_snapshot()["kv_waked_total"] == 2
    finally:
        a.stop()
    b = make_engine(params)
    try:
        b1, b2 = two_turns(b, park=True)         # parked, woken from host
        snap = b.scheduler.metrics_snapshot()
        assert snap["kv_parked_total"] == 1
        assert snap["kv_waked_total"] == 1
        assert snap["kv_pages_freed_total"] >= 1
    finally:
        b.stop()
    assert a1 == b1 == c1
    assert a2 == b2 == c2, "park/wake changed the resumed output"


@pytest.fixture(scope="module")
def quote():
    rparams = quote_params(RCFG, jax.random.PRNGKey(3), quantized=True)
    return rparams, params_from_numpy(jax.tree.map(np.asarray, rparams),
                                      device="cpu")


def _ref_run(engine, prompt, session="", ctx=(), max_tokens=12):
    stats = RefStats()
    req = RefRequest(prompt=prompt, session=session, context=tuple(ctx),
                     options=RefOptions(max_tokens=max_tokens,
                                        temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


def test_woken_stream_equals_the_jax_engine(quote):
    """Quote weights, int8 pool: three turns of one conversation (the
    second parked to the host before it wakes) and a second conversation
    on the port equal the JAX engine's greedy contexts, with the same
    wakes counted."""
    rparams, tparams = quote
    kw = dict(num_slots=2, max_seq=256, page_size=64, kv_quant=True,
              prefix_cache=False, kv_host_gb=1.0, kv_idle_s=1e9)
    ref = TPUEngine(rparams, RCFG, RefByteTokenizer(RCFG.vocab_size),
                    kv_mode="paged", **kw)
    port = TorchEngine(tparams, CFG, ByteTokenizer(CFG.vocab_size),
                       kv_mode="paged", device="cpu", **kw)
    try:
        for eng in (ref, port):
            eng.warmup(buckets=(64, 128))
        for eng in (ref, port):
            wait_for(eng.ready, timeout=300, msg="warmup")
        got = {}
        for name, eng, go in (("ref", ref, _ref_run), ("port", port, run)):
            ctxs = []
            _, s = go(eng, "abcabc hello hello", "q", max_tokens=12)
            ctxs.append(s.context)
            wait_for(lambda: eng.scheduler._tier.counts()[0] >= 1,
                     msg="retention")
            force_park(eng.scheduler)
            _, s = go(eng, " and again", "q", ctx=s.context, max_tokens=12)
            ctxs.append(s.context)
            _, s = go(eng, " then once more", "q", ctx=s.context,
                      max_tokens=12)
            ctxs.append(s.context)
            _, s = go(eng, "the quick brown fox", "other", max_tokens=12)
            ctxs.append(s.context)
            snap = eng.scheduler.metrics_snapshot()
            got[name] = (ctxs, snap["kv_waked_total"],
                         snap["kv_parked_total"])
        assert got["port"] == got["ref"]
        assert got["port"][1] == 2
    finally:
        ref.stop()
        port.stop()


# -- the slow matrix (the reference's) -------------------------------------------

def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


@pytest.mark.slow
def test_park_wake_bit_identity_bf16_pool(params):
    bf16 = _bf16(params)
    a, b = make_engine(bf16, kv_quant=False), make_engine(bf16,
                                                          kv_quant=False)
    try:
        assert two_turns(a, park=False) == two_turns(b, park=True)
        assert b.scheduler.metrics_snapshot()["kv_waked_total"] == 1
    finally:
        a.stop()
        b.stop()


@pytest.mark.slow
def test_session_rotates_and_rewakes_across_turns(params):
    def turns(park):
        eng = make_engine(params)
        try:
            out, ctx = [], ()
            for i, p in enumerate((PROMPT1, PROMPT2, " and a third turn")):
                t, s = run(eng, p, "rot", ctx=ctx)
                out.append(t)
                ctx = s.context
                wait_for(lambda: eng.scheduler._tier.counts()
                         in ((1, 0), (0, 1)), msg="retention")
                if park:
                    force_park(eng.scheduler)
            assert eng.scheduler.metrics_snapshot()["kv_waked_total"] == 2
            return out
        finally:
            eng.stop()

    assert turns(park=False) == turns(park=True)


@pytest.mark.slow
def test_park_wake_composes_with_prefix_cache(params):
    from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
    prompt = SUGGEST_PREFIX + "are we still on for lunch tomorrow?"

    def turns(park):
        eng = make_engine(params, prefix=True)
        try:
            t1, s1 = run(eng, prompt, "pc")
            wait_for(lambda: eng.scheduler._tier.counts()[0] >= 1,
                     msg="retention")
            if park:
                force_park(eng.scheduler)
            t2, _ = run(eng, PROMPT2, "pc", ctx=s1.context)
            snap = eng.scheduler.metrics_snapshot()
            assert snap["serve_prefix_admits_total"] == 1
            assert snap["kv_waked_total"] == 1
            return t1, t2
        finally:
            eng.stop()

    assert turns(False) == turns(True)


@pytest.mark.slow
def test_eviction_under_pressure_falls_back_cold(params):
    eng = make_engine(params, host_gb=1e-7)       # ~100 bytes: nothing fits
    try:
        _, s1 = run(eng, PROMPT1, "e")
        eng.scheduler._tier.idle_s = 0.0
        wait_for(lambda: eng.scheduler._tier.stats()["evicted_total"] >= 1,
                 msg="eviction")
        assert eng.scheduler._tier.counts() == (0, 0)
        t2, _ = run(eng, PROMPT2, "e", ctx=s1.context)
        snap = eng.scheduler.metrics_snapshot()
        assert snap["kv_waked_total"] == 0
        assert snap["kv_wake_cold_total"] >= 1
        assert len(t2) > 0
    finally:
        eng.stop()


@pytest.mark.slow
def test_pool_pressure_parks_residents_for_new_admissions(params):
    eng = make_engine(params, pages=7, slots=2)
    try:
        stats = {}
        for i in range(6):
            _, stats[i] = run(eng, f"session {i}: " + PROMPT1, f"m{i}")
        wait_for(lambda: eng.scheduler.metrics_snapshot()[
            "kv_open_sessions"] == 6, msg="all sessions open")
        snap = eng.scheduler.metrics_snapshot()
        assert snap["kv_parked_total"] >= 3
        assert snap["kv_host_bytes"] > 0
        run(eng, PROMPT2, "m0", ctx=stats[0].context)
        assert eng.scheduler.metrics_snapshot()["kv_waked_total"] == 1
    finally:
        eng.stop()
