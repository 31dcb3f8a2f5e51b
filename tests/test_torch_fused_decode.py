"""Fused K-step decode in the port (models/llama.decode_fused,
models/mixtral.decode_fused, the scheduler's fused ticks), on the CPU.

- **Fused equals plain, bitwise.** ``decode_fused`` with K = 4 against
  four sequential ``decode_step_paged`` + ``sample_step_batched`` steps
  with the host's stop->park between them: tokens, keys, ring, feed,
  lengths and pool bytes (int8 values and scales included), for llama
  ``tiny`` and mixtral ``tiny-moe``, an int8 pool on the gather branch
  and a bf16 pool on ``kernel`` (write-then-attend), greedy,
  temperature+top_p and top_k+repeat-penalty rows in one batch (the
  reference's TEMPS/TOP_KS/TOP_PS/RPS), with and without a row whose EOS
  lands mid-burst.
- **Equal to the JAX package.** Greedy ``decode_fused`` tokens equal the
  reference's paged ``decode_fused`` (Pallas in interpret mode) on the
  quote-workload weights (models/synth.quote_params) carried across by
  models/convert.
- **The fuse-K decision table** of the reference
  (tests/test_fused_decode.py:225-318) against the port's
  ``_choose_fuse_k``, case for case.
- **Engine streams** are identical with ``decode_fuse_max`` 1 and 4,
  greedy and seeded, the fused engine fuses, and its greedy ``context``
  equals the JAX engine's at ``decode_fuse_max=4``.
- **Pipeline bookkeeping**: a stream cancelled while its tick is in
  flight, a new request admitted into the same row before that tick is
  read back; the new stream is the one it gives alone, and the pool
  drains back to its total.
- **Capture safety, as far as the CPU shows it**: a fused tick runs with
  ``Tensor.item``/``tolist``/``cpu``/``numpy`` patched to raise, and
  ``_reset_device_state`` keeps every persistent tensor's address.
"""

import queue
import threading
import time

import jax
import jax.numpy as jnp
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
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.sampling import sample_step_batched
from p2p_llm_chat_tpu_torch.ops.paged_kv import (PagedKVCache,
                                                 write_prefill_batch)
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler, _Slot
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

B, K, RING, MAX_SEQ, PS = 3, 4, 64, 64, 16
TEMPS = torch.tensor([0.0, 0.8, 0.6])
TOP_KS = torch.tensor([0, 0, 9])
TOP_PS = torch.tensor([1.0, 0.9, 1.0])
RPS = torch.tensor([1.0, 1.0, 1.2])
PROMPT_LENS = (5, 8, 3)
MPPR = MAX_SEQ // PS


def _sample_fn(logits, state, emit_pos, act):
    keys, ring = state
    toks, keys, ring = sample_step_batched(
        logits, keys, TEMPS, TOP_KS, TOP_PS, ring=ring, rp=RPS,
        emit_pos=emit_pos, active=act)
    return toks, (keys, ring)


def _params(config: str, dtype=torch.bfloat16) -> dict:
    cfg = get_config(config)
    return family_for(cfg).init_params_quantized(cfg, seed=1, dtype=dtype,
                                                 quant="int8", device="cpu")


def _state(config: str, params: dict, quantized: bool):
    """Three prompts prefilled into a fresh pool; the greedy first token
    of each row, per-row keys and an empty ring."""
    cfg = get_config(config)
    fam = family_for(cfg)
    gen = torch.Generator().manual_seed(2)
    S = max(PROMPT_LENS)
    toks = torch.randint(3, cfg.vocab_size, (B, S), generator=gen)
    lens = torch.tensor(PROMPT_LENS)
    logits, k_all, v_all = fam.prefill(params, cfg, toks, lens,
                                       last_only=True)
    cache = PagedKVCache.create(cfg, B, B * MPPR + 1, PS,
                                max_pages_per_row=MPPR,
                                dtype=params["embed"].dtype,
                                quantized=quantized, device="cpu")
    tables = 1 + torch.arange(B * MPPR, dtype=torch.int32).reshape(B, MPPR)
    write_prefill_batch(cache, k_all, v_all, torch.arange(B), lens, tables)
    first = logits[:, 0].argmax(-1)[:, None]
    keys = torch.tensor([[11, 0], [22, 0], [33, 0]])
    ring = torch.full((B, RING), cfg.vocab_size, dtype=torch.long)
    return first, cache, keys, ring


def _clone(cache: PagedKVCache) -> PagedKVCache:
    return PagedKVCache(*(None if t is None else t.clone() for t in (
        cache.k, cache.v, cache.page_table, cache.lengths, cache.k_scale,
        cache.v_scale)))


def _plain(fam, params, cfg, tokens, cache, keys, ring, stop, impl):
    """K plain steps, with the host's stop->park between them."""
    active = torch.ones(B, dtype=torch.bool)
    outs, acts = [], []
    for _ in range(K):
        emit_pos = cache.lengths + 1
        logits, cache = fam.decode_step_paged(params, cfg, tokens, cache,
                                              active, pages=MPPR, impl=impl)
        toks, keys, ring = sample_step_batched(
            logits[:, 0], keys, TEMPS, TOP_KS, TOP_PS, ring=ring, rp=RPS,
            emit_pos=emit_pos, active=active)
        tokens = torch.where(active[:, None], toks[:, None], tokens)
        outs.append(toks)
        acts.append(active)
        active = active & ~torch.isin(toks, stop)
    return (torch.stack(outs), torch.stack(acts), tokens, cache, active,
            (keys, ring))


@pytest.mark.parametrize("stop_mid_burst", [False, True])
@pytest.mark.parametrize("impl,quantized", [("gather", True),
                                            ("kernel", False)])
@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_fused_k_steps_bitwise_equal_to_plain_steps(config, impl, quantized,
                                                    stop_mid_burst):
    cfg = get_config(config)
    fam = family_for(cfg)
    params = _params(config)
    first, cache, keys, ring = _state(config, params, quantized)
    stop = torch.empty(0, dtype=torch.long)
    if stop_mid_burst:
        # Stop on the greedy row's token at step 1: its EOS lands strictly
        # inside the burst.
        probe = _plain(fam, params, cfg, first, _clone(cache), keys, ring,
                       stop, impl)
        stop = probe[0][1, :1].clone()
    plain = _plain(fam, params, cfg, first, _clone(cache), keys, ring, stop,
                   impl)
    fused = fam.decode_fused(params, cfg, first, _clone(cache),
                             torch.ones(B, dtype=torch.bool), num_steps=K,
                             sample_fn=_sample_fn, sample_state=(keys, ring),
                             stop_ids=stop, pages=MPPR, impl=impl)
    names = ("tokens", "emitted", "next", "cache", "active", "state")
    for name, p, f in zip(names, plain, fused):
        if name == "cache":
            for field in ("k", "v", "page_table", "lengths", "k_scale",
                          "v_scale"):
                pt, ft = getattr(p, field), getattr(f, field)
                assert (pt is None) == (ft is None)
                assert pt is None or torch.equal(pt, ft), field
        elif name == "state":
            assert torch.equal(p[0], f[0]) and torch.equal(p[1], f[1])
        else:
            assert torch.equal(p, f), name
    emitted = fused[1].sum(dim=0)
    assert fused[3].lengths.tolist() == [
        n + int(e) for n, e in zip(PROMPT_LENS, emitted)]
    if stop_mid_burst:
        assert not bool(fused[4][0]), "the greedy row should have parked"
        assert int(emitted[0]) < K


def _ref_paged_state(params, cfg, prompts):
    toks = np.zeros((B, 16), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    fam = ref_mixtral if cfg.is_moe else ref_llama
    small = KVCache.create(cfg, B, 16, dtype=params["embed"].dtype)
    logits, small = fam.prefill(params, cfg, jnp.asarray(toks),
                                jnp.asarray(lens), small, last_only=True)
    tables = (1 + np.arange(B * MPPR, dtype=np.int32)).reshape(B, MPPR)
    cache = ref_kv.PagedKVCache.create(cfg, B, B * MPPR + 1, PS,
                                       max_pages_per_row=MPPR,
                                       dtype=params["embed"].dtype,
                                       quantized=True)
    cache = ref_kv.write_prefill_batch(cache, small.k, small.v,
                                       jnp.arange(B), jnp.asarray(lens),
                                       jnp.asarray(tables))
    first = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
    return toks, lens, tables, first, cache


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_greedy_fused_tokens_equal_the_reference(config):
    """Two fused ticks of K = 4, greedy rows, int8 pool: the port's
    tokens equal the reference's ``decode_fused`` on the quote weights."""
    rcfg = ref_config(config)
    rparams = quote_params(rcfg, jax.random.PRNGKey(3), quantized=True)
    prompts = [[1, 40, 41, 42], [1, 300, 301, 302, 303, 304, 305],
               [1, 77, 78]]
    toks, lens, tables, rfirst, rcache = _ref_paged_state(rparams, rcfg,
                                                          prompts)
    zeros = jnp.zeros((B,), jnp.float32)
    ones = jnp.ones((B,), jnp.float32)

    def ref_sample(logits, state, emit_pos, act):
        keys, ring = state
        t, keys, ring = ref_sampling.sample_step_batched(
            logits, keys, zeros, jnp.zeros((B,), jnp.int32), ones,
            ring=ring, rp=ones, emit_pos=emit_pos, active=act)
        return t, (keys, ring)

    ref_fam = ref_mixtral if rcfg.is_moe else ref_llama
    run = jax.jit(lambda t, c, s: ref_fam.decode_fused(
        rparams, rcfg, t, c, active=jnp.ones((B,), bool), num_steps=K,
        sample_fn=ref_sample, sample_state=s,
        stop_ids=np.zeros((0,), np.int32), pages=MPPR, interpret=True))
    state = (jax.random.split(jax.random.PRNGKey(0), B),
             jnp.full((B, RING), rcfg.vocab_size, jnp.int32))
    ref_blocks, feed = [], rfirst
    for _ in range(2):
        out, _, feed, rcache, _, state = run(feed, rcache, state)
        ref_blocks.append(np.asarray(out))

    cfg = get_config(config)
    fam = family_for(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams),
                               device="cpu")
    logits, k_all, v_all = fam.prefill(params, cfg,
                                       torch.from_numpy(toks).long(),
                                       torch.from_numpy(lens),
                                       last_only=True)
    cache = PagedKVCache.create(cfg, B, B * MPPR + 1, PS,
                                max_pages_per_row=MPPR,
                                dtype=params["embed"].dtype, quantized=True,
                                device="cpu")
    write_prefill_batch(cache, k_all, v_all, torch.arange(B),
                        torch.from_numpy(lens), torch.from_numpy(tables))
    feed = logits[:, 0].argmax(-1)[:, None]
    assert feed[:, 0].tolist() == np.asarray(rfirst)[:, 0].tolist()
    greedy = torch.zeros(B)

    def sample(logits, state, emit_pos, act):
        keys, ring = state
        t, keys, ring = sample_step_batched(
            logits, keys, greedy, torch.zeros(B, dtype=torch.long),
            torch.ones(B), ring=ring, rp=torch.ones(B), emit_pos=emit_pos,
            active=act)
        return t, (keys, ring)

    state = (torch.zeros((B, 2), dtype=torch.long),
             torch.full((B, RING), cfg.vocab_size, dtype=torch.long))
    for want in ref_blocks:
        out, _, feed, cache, _, state = fam.decode_fused(
            params, cfg, feed, cache, None, num_steps=K, sample_fn=sample,
            sample_state=state, stop_ids=torch.empty(0, dtype=torch.long),
            pages=MPPR)
        np.testing.assert_array_equal(out.numpy(), want)


# -- the fuse-K decision table (the reference's, case for case) -----------

def _mk_slot(max_new=100, n_ids=0, ctx_len=10, ctx_budget=60) -> _Slot:
    s = _Slot(req=GenerateRequest(prompt="x"), stats=None,
              out_q=queue.Queue(), seed=0)
    s.max_new, s.ctx_len, s.ctx_budget = max_new, ctx_len, ctx_budget
    s.ids = list(range(n_ids))
    return s


@pytest.fixture(scope="module")
def tiny_params():
    return _params("tiny")


def _policy_probe(params, prefill_chunk, max_seq=MAX_SEQ):
    """A scheduler whose loop thread is already joined: _choose_fuse_k
    is probed as a pure policy function."""
    cfg = get_config("tiny")
    sched = BatchScheduler(params, cfg, ByteTokenizer(cfg.vocab_size),
                           num_slots=2, max_seq=max_seq, decode_fuse_max=4,
                           prefill_chunk=prefill_chunk, kv_mode="paged",
                           device="cpu")
    sched.stop()
    return sched


def test_fuse_k_policy_decision_table(tiny_params):
    chunked = _policy_probe(tiny_params, prefill_chunk=64)
    chunked._slots[0] = _mk_slot()
    for plant, clear in (
            (lambda: chunked._admit_q.put(object()),
             lambda: chunked._admit_q.get_nowait()),
            (lambda: chunked._admit_carry.append(_mk_slot()),
             lambda: chunked._admit_carry.clear()),
            (lambda: chunked._waiting.append(_mk_slot()),
             lambda: chunked._waiting.clear())):
        plant()
        chunked._fuse_ramp = 1
        # Pending admission alone: K keeps ramping 2 -> 4, holds at cap.
        assert chunked._choose_fuse_k(0) == 2
        assert chunked._choose_fuse_k(0) == 4
        assert chunked._choose_fuse_k(0) == 4
        # ...but a near-budget row still collapses K to 1.
        chunked._slots[1] = _mk_slot(ctx_len=59, ctx_budget=60)
        assert chunked._choose_fuse_k(0) == 1
        chunked._slots[1] = None
        clear()

    # Chunking on but max_seq not a chunk multiple: the legacy collapse.
    capped = _policy_probe(tiny_params, prefill_chunk=64, max_seq=200)
    capped._slots[0] = _mk_slot()
    capped._fuse_ramp = 4
    capped._admit_q.put(object())
    assert capped._choose_fuse_k(0) == 1
    capped._admit_q.get_nowait()
    assert capped._choose_fuse_k(0) == 2

    single = _policy_probe(tiny_params, prefill_chunk=0)
    single._slots[0] = _mk_slot()
    single._fuse_ramp = 4
    single._admit_q.put(object())
    assert single._choose_fuse_k(0) == 1
    single._admit_q.get_nowait()
    assert single._choose_fuse_k(0) == 2
    single._admit_carry = [_mk_slot()]
    assert single._choose_fuse_k(0) == 1
    single._admit_carry = []
    single._waiting = [_mk_slot()]
    assert single._choose_fuse_k(0) == 1
    single._waiting = []
    assert single._choose_fuse_k(0) == 2
    assert single._choose_fuse_k(0) == 4
    assert single._choose_fuse_k(0) == 4


def test_adaptive_k_respects_row_budgets(tiny_params):
    sched = _policy_probe(tiny_params, prefill_chunk=256)
    # A row within K tokens of max_new: collapse to 1.
    sched._slots[0] = _mk_slot(max_new=8, n_ids=7)
    assert sched._choose_fuse_k(0) == 1
    # A row within K tokens of its KV budget: collapse to 1.
    sched._slots[0] = _mk_slot(ctx_len=59, ctx_budget=60)
    assert sched._choose_fuse_k(0) == 1
    # In-flight pipelined steps count against the headroom.
    sched._slots[0] = _mk_slot(max_new=10, n_ids=5)
    assert sched._choose_fuse_k(4) == 1
    assert sched._choose_fuse_k(0) == 2
    # Headroom for 2 but not 4: K clamps to the ladder's 2.
    sched._slots[0] = _mk_slot(max_new=8, n_ids=5)
    sched._fuse_ramp = 4
    assert sched._choose_fuse_k(0) == 2


# -- engines ----------------------------------------------------------------

@pytest.fixture(scope="module")
def quote():
    cfg = ref_config("tiny")
    params = quote_params(cfg, jax.random.PRNGKey(5), quantized=True)
    return cfg, params, params_from_numpy(jax.tree.map(np.asarray, params),
                                          device="cpu")


def _engine(params, fuse: int, **kw) -> TorchEngine:
    cfg = get_config("tiny")
    args = dict(num_slots=2, max_seq=128, page_size=16, kv_quant=True,
                decode_fuse_max=fuse, kv_mode="paged", device="cpu")
    args.update(kw)
    return TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), **args)


@pytest.mark.parametrize("opts", [
    dict(max_tokens=24),
    dict(max_tokens=24, temperature=0.8, top_p=0.9, seed=5),
    dict(max_tokens=24, temperature=0.7, top_k=20, repeat_penalty=1.3,
         seed=9)])
def test_engine_streams_identical_with_fusion_on(quote, opts):
    _, _, params = quote
    off, on = _engine(params, 1), _engine(params, 4)
    try:
        texts = []
        for engine in (off, on):
            stats = RequestStats()
            texts.append((collect(engine, GenerateRequest(
                prompt="fused parity", options=GenerateOptions(**opts)),
                stats), stats.context))
        assert texts[0] == texts[1]
        snap = on.metrics_snapshot()
        assert snap["decode_fused_ticks_total"] > 0
        assert snap["decode_fused_mean_k"] > 1.0
        assert off.metrics_snapshot()["decode_fused_ticks_total"] == 0
    finally:
        off.stop()
        on.stop()


def test_fused_greedy_context_matches_the_jax_engine(quote):
    rcfg, rparams, params = quote
    ref = TPUEngine(rparams, rcfg, RefByteTokenizer(rcfg.vocab_size),
                    num_slots=2, max_seq=128, kv_mode="paged", page_size=16,
                    kv_quant=True, prefix_cache=False, decode_fuse_max=4,
                    prefill_chunk=0)
    engine = _engine(params, 4)
    try:
        for prompt in ("abc", "the quick brown fox"):
            ref_stats, stats = RefStats(), RequestStats()
            ref_collect(ref, RefRequest(prompt=prompt,
                                        options=RefOptions(max_tokens=16)),
                        ref_stats)
            collect(engine, GenerateRequest(
                prompt=prompt, options=GenerateOptions(max_tokens=16)),
                stats)
            assert stats.completion_tokens > 0
            assert stats.context == ref_stats.context
        assert engine.metrics_snapshot()["decode_fused_mean_k"] > 1.0
    finally:
        ref.stop()
        engine.stop()


def test_cancel_in_flight_and_readmit_into_the_same_row(quote):
    """Drive the pipeline by hand (the loop thread parked in a job): A's
    tick is in flight when A is cancelled; B is admitted into A's row
    while a tick that still carries A is in flight; that tick is skipped
    for B by identity. B's text equals B alone, and every page returns."""
    _, _, params = quote
    alone = _engine(params, 4, num_slots=1)
    try:
        want = collect(alone, GenerateRequest(
            prompt="second", options=GenerateOptions(max_tokens=12)))
    finally:
        alone.stop()
    engine = _engine(params, 4, num_slots=1)
    sched = engine.scheduler
    hold = threading.Event()
    sched.post_on_loop(hold.wait)
    try:
        deadline = time.monotonic() + 30
        while not sched._jobs.empty():          # the loop took the job
            assert time.monotonic() < deadline
            time.sleep(0.01)
        a = engine.generate_stream(GenerateRequest(
            prompt="first", options=GenerateOptions(max_tokens=40)))
        sched._admit_pending(block=False)
        slot_a = sched._slots[0]
        assert slot_a is not None
        tick1 = sched._dispatch_tick(0)
        a.close()                               # A cancelled, tick 1 in flight
        tick2 = sched._dispatch_tick(tick1[3])
        sched._process_tick(*tick1)             # releases row 0
        assert sched._slots[0] is None
        b = engine.generate_stream(GenerateRequest(
            prompt="second", options=GenerateOptions(max_tokens=12)))
        sched._admit_pending(block=False)       # B into row 0; tick 2 carries A
        assert sched._slots[0] is not None and sched._slots[0] is not slot_a
        pending = tick2
        while sched._any_active():
            new = sched._dispatch_tick(pending[3])
            sched._process_tick(*pending)
            pending = new
        sched._process_tick(*pending)
        assert "".join(b) == want
        snap = engine.metrics_snapshot()
        assert snap["serve_kv_free_pages"] == snap["serve_kv_total_pages"]
    finally:
        hold.set()
        engine.stop()


def test_a_fused_tick_makes_no_host_sync_and_reset_keeps_addresses(
        quote, monkeypatch):
    _, _, params = quote
    engine = _engine(params, 4)
    sched = engine.scheduler
    try:
        collect(engine, GenerateRequest(
            prompt="warm", options=GenerateOptions(max_tokens=8)))
        persistent = [sched._cache.k, sched._cache.v, sched._cache.k_scale,
                      sched._cache.v_scale, sched._cache.page_table,
                      sched._cache.lengths, sched._next, sched._temps_dev,
                      sched._top_ks_dev, sched._top_ps_dev, sched._rps_dev,
                      sched._keys_dev, sched._ring_dev, sched._active_dev,
                      *sched._toks_out.values()]
        ptrs = [t.data_ptr() for t in persistent]
        sched._active_dev.fill_(True)
        sched._temps_dev.copy_(torch.tensor([0.0, 0.9]))

        def boom(*args, **kwargs):
            raise AssertionError("host sync inside a decode tick")

        program = sched._decode_fused_for(128, 4)
        for name in ("item", "tolist", "cpu", "numpy"):
            monkeypatch.setattr(torch.Tensor, name, boom)
        program()
        monkeypatch.undo()
        sched._reset_device_state()
        assert [t.data_ptr() for t in persistent] == ptrs
        assert not bool(sched._active_dev.any())
        assert int(sched._cache.lengths.sum()) == 0
    finally:
        monkeypatch.undo()
        engine.stop()
