"""The KV tier over the dense cache (``SERVE_KV=dense`` with the tier on),
the port against the JAX engine with ``kv_mode="dense"``, on the CPU.

- Park at finish: a finished request's session is parked at once (no
  resident phase), under the JAX engine's key, tokens, length and width
  W; its k/v equal the JAX engine's row within 1e-4 of the cache scale
  (f32 activations: test_torch_dense.py's tolerance for dense cache
  writes), llama ``tiny`` and mixtral ``tiny-moe``.
- Wake, on the reference's quote weights: three turns of a conversation
  (turns 2 and 3 woken through the verify-shaped forward on the cache's
  identity view) and a second conversation give the JAX dense engine's
  greedy contexts with the same wakes and parks counted, and the woken
  turn 2 equals the port's own cold turn 2 (no tier).
- Payload checks: dense payloads of the wrong L, Hkv, D or dtype, a width
  past max_seq or other than the arrays', a length past the width, ids
  outside the vocab, and a paged payload reject on a dense engine; a
  dense payload rejects on a paged engine; a good one imports.
- A wake under live traffic leaves a decoding row's greedy stream equal
  to its solo run; a dense warm wake writes only a free row, and none
  while every row is held.
- With ``SERVE_DRAFT`` (a resident draft model) and the tier on, the
  woken row's greedy stream equals speculation off.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve import kv_tier as ref_tier
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve import kv_tier
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.serve.scheduler import _WarmupJob
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

_REF = {"tiny": ref_llama, "tiny-moe": ref_mixtral}
KW = dict(num_slots=2, max_seq=256, prefix_cache=False, kv_host_gb=1.0,
          kv_idle_s=1e9, kv_mode="dense")
TURNS = ("abcabc hello hello", " and again", " then once more")


def run(engine, prompt, session="", ctx=(), max_tokens=12):
    stats = RequestStats()
    req = GenerateRequest(prompt=prompt, session=session, context=tuple(ctx),
                          options=GenerateOptions(max_tokens=max_tokens,
                                                  temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


def _ref_run(engine, prompt, session="", ctx=(), max_tokens=12):
    stats = RefStats()
    req = RefRequest(prompt=prompt, session=session, context=tuple(ctx),
                     options=RefOptions(max_tokens=max_tokens,
                                        temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _port_engine(params, config="tiny", **kw):
    cfg = get_config(config)
    return TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size),
                       device="cpu", **dict(KW, **kw))


def _on_loop(sched, fn):
    """Run ``fn`` on the scheduler thread between iterations."""
    job = _WarmupJob(fn)
    sched._admit_q.put(job)
    assert job.done.wait(60), "the loop never ran the job"
    if job.err is not None:
        raise job.err


@pytest.mark.parametrize("config", ["tiny", "tiny-moe"])
def test_parked_row_equals_the_jax_engine(config):
    rcfg = ref_config(config)
    rparams = _REF[config].init_params_quantized(
        rcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams),
                                device="cpu")
    ref = TPUEngine(rparams, rcfg, RefByteTokenizer(rcfg.vocab_size), **KW)
    port = _port_engine(tparams, config)
    try:
        _ref_run(ref, TURNS[0], "p", max_tokens=8)
        run(port, TURNS[0], "p", max_tokens=8)
        for eng in (ref, port):
            wait_for(lambda: eng.scheduler._tier.counts() == (0, 1),
                     msg="park at finish")
        # Nothing is ever resident: park_all has nothing to move.
        port.scheduler.park_all()
        assert port.scheduler.metrics_snapshot()["kv_parked_total"] == 1
        want = ref_tier.deserialize_session(ref.session_export("sid:p"))
        got = kv_tier.deserialize_session(port.session_export("sid:p"))
        assert (got.key, got.tokens, got.length, got.host[1]) == (
            want.key, want.tokens, want.length, want.host[1])
        n, W = got.length, got.host[1]
        assert W == 32 and n <= W
        for g, w in zip(got.host[0], want.host[0]):
            assert tuple(g.shape) == w.shape == (
                rcfg.num_layers, W, rcfg.num_kv_heads, rcfg.head_dim)
            w = np.asarray(w, np.float32)[:, :n]
            np.testing.assert_allclose(g.numpy()[:, :n], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    finally:
        ref.stop()
        port.stop()


@pytest.fixture(scope="module", params=["tiny", "tiny-moe"])
def quote(request):
    rcfg = ref_config(request.param)
    rparams = quote_params(rcfg, jax.random.PRNGKey(3), quantized=True)
    return request.param, rcfg, rparams, params_from_numpy(
        jax.tree.map(np.asarray, rparams), device="cpu")


def test_woken_turns_equal_the_jax_engine_and_cold(quote):
    config, rcfg, rparams, tparams = quote
    ref = TPUEngine(rparams, rcfg, RefByteTokenizer(rcfg.vocab_size), **KW)
    port = _port_engine(tparams, config)
    cold = _port_engine(tparams, config, kv_host_gb=0.0)
    try:
        for eng in (ref, port):
            eng.warmup(buckets=(64,))
        for eng in (ref, port):
            wait_for(eng.ready, timeout=300, msg="warmup")
        got = {}
        for name, eng, go in (("ref", ref, _ref_run), ("port", port, run)):
            ctxs, ctx = [], ()
            for turn in TURNS:
                _, s = go(eng, turn, "q", ctx=ctx)
                ctx = s.context
                ctxs.append(ctx)
                wait_for(lambda: eng.scheduler._tier.counts() == (0, 1),
                         msg="park at finish")
            _, s = go(eng, "the quick brown fox", "other")
            ctxs.append(s.context)
            wait_for(lambda: eng.scheduler._tier.counts() == (0, 2),
                     msg="park at finish")
            snap = eng.scheduler.metrics_snapshot()
            got[name] = (ctxs, snap["kv_waked_total"],
                         snap["kv_parked_total"])
        assert got["port"] == got["ref"]
        assert got["port"][1:] == (2, 4)
        _, s = run(cold, TURNS[0], "q")
        _, s = run(cold, TURNS[1], "q", ctx=s.context)
        assert s.context == got["port"][0][1]
    finally:
        ref.stop()
        port.stop()
        cold.stop()


# -- payload checks ------------------------------------------------------------

CFG = get_config("tiny")
L, HKV, D = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim


def _dense_sess(key, W=64, length=40, shape=None, dtype=torch.float32,
                tokens=None):
    k = torch.zeros(shape or (L, W, HKV, D), dtype=dtype)
    toks = tokens or tuple(range(3, 3 + length))
    return kv_tier.SessionKV(key=key, tokens=toks, length=length,
                             host=((k, k.clone()), W),
                             nbytes=2 * kv_tier.tensor_nbytes(k))


def _paged_sess(key):
    k = torch.zeros((L, 1, 64, HKV, D), dtype=torch.int8)
    s = torch.zeros((L, 1, HKV, 128))
    return kv_tier.SessionKV(key=key, tokens=tuple(range(3, 43)), length=40,
                             host=((k, k.clone(), s, s.clone()), 1),
                             nbytes=1)


REJECTS = {
    "layers": lambda: _dense_sess("sid:r", shape=(L + 1, 64, HKV, D)),
    "kv_heads": lambda: _dense_sess("sid:r", shape=(L, 64, HKV + 1, D)),
    "head_dim": lambda: _dense_sess("sid:r", shape=(L, 64, HKV, D // 2)),
    "dtype": lambda: _dense_sess("sid:r", dtype=torch.float16),
    "span_past_max_seq": lambda: _dense_sess("sid:r", W=512),
    "span_not_width": lambda: kv_tier.SessionKV(
        key="sid:r", tokens=tuple(range(3, 43)), length=40,
        host=(_dense_sess("sid:r").host[0], 128), nbytes=1),
    "length_past_span": lambda: _dense_sess("sid:r", W=32, length=40),
    "vocab": lambda: _dense_sess(
        "sid:r", tokens=tuple(range(3, 42)) + (CFG.vocab_size,)),
    "paged_kind": lambda: _paged_sess("sid:r"),
}


@pytest.fixture(scope="module")
def engines():
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            ref_llama.init_params_quantized(
                                                ref_config("tiny"),
                                                jax.random.PRNGKey(0),
                                                dtype=jnp.float32)),
                               device="cpu")
    dense = _port_engine(params)
    paged = _port_engine(params, kv_mode="paged", kv_quant=True,
                         page_size=64)
    yield dense, paged
    dense.stop()
    paged.stop()


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_dense_engine_rejects_incompatible_payloads(engines, case):
    dense, _ = engines
    before = dense.session_list()
    sess = REJECTS[case]()
    assert dense.session_import(kv_tier.serialize_session(sess)) is None
    assert dense.session_list() == before


def test_dense_payload_imports_only_into_a_dense_engine(engines):
    dense, paged = engines
    wire = kv_tier.serialize_session(_dense_sess("sid:ok"))
    assert paged.session_import(wire) is None
    assert "sid:ok" not in paged.session_list()
    got = dense.session_import(wire)
    assert got is not None and got.key == "sid:ok" and got.parked
    assert dense.session_forget("sid:ok") is True


# -- live traffic ----------------------------------------------------------------

def test_wake_under_live_traffic_leaves_a_decoding_row(quote):
    """Row A decodes a long greedy answer while session q wakes into the
    other row: A's stream equals its solo run, and the wake ran while A
    was live."""
    config, _, _, tparams = quote
    eng = _port_engine(tparams, config, decode_fuse_max=1)
    try:
        eng.warmup(buckets=(16, 32, 64))
        wait_for(eng.ready, timeout=300, msg="warmup")
        long_prompt = "the quick brown fox"
        _, solo = run(eng, long_prompt, "solo", max_tokens=200)
        _, s1 = run(eng, TURNS[0], "q")
        wait_for(lambda: "sid:q" in eng.session_list(), msg="park")
        sched = eng.scheduler
        live_at_wake = []
        inner = sched._admit_wake

        def spy(chunk, rows, S):
            live_at_wake.append(sched._any_active())
            return inner(chunk, rows, S)

        sched._admit_wake = spy
        stats = RequestStats()
        stream = eng.generate_stream(GenerateRequest(
            prompt=long_prompt, session="live",
            options=GenerateOptions(max_tokens=200, temperature=0.0,
                                    seed=1)), stats)
        first = next(stream)
        rest = []
        reader = threading.Thread(target=lambda: rest.extend(stream))
        reader.start()
        _, s2 = run(eng, TURNS[1], "q", ctx=s1.context)
        reader.join(60)
        assert first and not reader.is_alive()
        assert stats.context == solo.context
        assert live_at_wake == [True]
        assert sched.metrics_snapshot()["kv_waked_total"] == 1
        cold = _port_engine(tparams, config, kv_host_gb=0.0)
        try:
            _, c = run(cold, TURNS[0], "q")
            _, c = run(cold, TURNS[1], "q", ctx=c.context)
        finally:
            cold.stop()
        assert s2.context == c.context
    finally:
        eng.stop()


def test_dense_warm_wake_writes_only_a_free_row():
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            ref_llama.init_params_quantized(
                                                ref_config("tiny"),
                                                jax.random.PRNGKey(0),
                                                dtype=jnp.float32)),
                               device="cpu")
    eng = _port_engine(params, num_slots=3)
    sched = eng.scheduler
    held = object()
    out = {}

    def job():
        cache = sched._cache
        gen = torch.Generator().manual_seed(0)
        cache.k.copy_(torch.randn(cache.k.shape, generator=gen))
        cache.v.copy_(torch.randn(cache.v.shape, generator=gen))
        k0, v0 = cache.k.clone(), cache.v.clone()
        sched._slots[0] = sched._slots[2] = held
        try:
            sched._wake_shapes_run.clear()
            for w in sched._window_ladder():
                for S in (16, 64):
                    sched._warm_wake(w, S)
            out["shapes"] = set(sched._wake_shapes_run)
            k1, v1 = cache.k.clone(), cache.v.clone()
            sched._slots[1] = held
            sched._wake_shapes_run.clear()
            sched._warm_wake(128, 16)
            out["shapes_full"] = set(sched._wake_shapes_run)
            out["unchanged_full"] = (torch.equal(cache.k, k1)
                                     and torch.equal(cache.v, v1))
        finally:
            sched._slots[:] = [None] * 3
        out["held"] = all(torch.equal(a[:, r], b[:, r])
                          for a, b in ((cache.k, k0), (cache.v, v0))
                          for r in (0, 2))
        out["free"] = not torch.equal(k1[:, 1, :64], k0[:, 1, :64])
        out["free_tail"] = torch.equal(k1[:, 1, 64:], k0[:, 1, 64:])

    try:
        _on_loop(sched, job)
        assert out["shapes"] == {(w, S) for w in (128, 256)
                                 for S in (16, 64)}
        assert out["held"], "a warm wake wrote a held row"
        assert out["free"] and out["free_tail"]
        assert out["shapes_full"] == set() and out["unchanged_full"]
    finally:
        eng.stop()


# -- the resident draft model ---------------------------------------------------

def test_woken_row_with_the_drafter_equals_spec_off():
    rcfg = ref_config("tiny")
    rdcfg = rcfg.with_(num_layers=1, name="tiny-draft", max_seq_len=1024)
    port = lambda p: params_from_numpy(jax.tree.map(np.asarray, p),
                                       device="cpu")
    target = port(quote_params(rcfg, jax.random.PRNGKey(0),
                               dtype=jnp.float32, mode="freeform"))
    draft = port(quote_params(rdcfg, jax.random.PRNGKey(1),
                              dtype=jnp.float32, mode="freeform"))
    dcfg = CFG.with_(num_layers=1, name="tiny-draft", max_seq_len=1024)
    on = _port_engine(target, spec_k=4, spec_tree_nodes=0,
                      draft=(draft, dcfg))
    off = _port_engine(target)
    try:
        assert on.drafter is not None
        got = []
        for eng in (on, off):
            ctxs, ctx = [], ()
            for turn in ("Tell me something new about the harbor lights",
                         " and then the boats"):
                _, s = run(eng, turn, "d", ctx=ctx, max_tokens=24)
                ctx = s.context
                ctxs.append(ctx)
                wait_for(lambda: "sid:d" in eng.session_list(),
                         msg="park at finish")
            snap = eng.scheduler.metrics_snapshot()
            assert snap["kv_waked_total"] == 1
            got.append(ctxs)
        assert got[0] == got[1]
        assert on.scheduler.metrics_snapshot()[
            "serve_spec_accepted_total"] > 0
    finally:
        on.stop()
        off.stop()
