"""The port's engine over the dense KV cache (``SERVE_KV=dense``, the
reference's default and now the port's) against the JAX engine with
``kv_mode="dense"``, on the CPU, greedy, on the reference's quote weights
carried across (llama ``tiny`` and mixtral ``tiny-moe``, int8 weights;
the quote head leaves no near-ties, so the contexts compare exactly).

- the env default builds a dense engine, and its greedy ``context`` ids
  equal the JAX engine's;
- chunked admission (``prefill_chunk`` 16 under a 60-byte prompt) and
  prefix-spliced admission (a registered template) equal the JAX
  engine's, with the chunk and prefix counters moving;
- n-gram speculation, linear and tree, equals speculation off on the same
  weights and equals the JAX engine's spec stream;
- the dense gauges: no page-pool series on ``/metrics``;
- the refusals: ``SERVE_KV_QUANT=int8`` with dense (the reference's
  message) and an unknown ``SERVE_KV``; the KV tier and a prefill replica
  class over the dense cache build and serve a session.
"""

import time

import jax
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats,
                                            collect as ref_collect)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models import llama
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import (SUGGEST_PREFIX, TorchEngine,
                                                 build_engine_from_env)
from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

PROMPTS = ("abcabc hello hello", "the quick brown fox",
           "0123456789:;<=>?0123456789 and then some more text, on and on!")


@pytest.fixture(scope="module", params=["tiny", "tiny-moe"])
def quote(request):
    rcfg = ref_config(request.param)
    rparams = quote_params(rcfg, jax.random.PRNGKey(3), quantized=True)
    return request.param, rcfg, rparams, params_from_numpy(
        jax.tree.map(np.asarray, rparams), device="cpu")


def _engine(config, params, **kw):
    cfg = get_config(config)
    args = dict(num_slots=2, max_seq=128, kv_mode="dense",
                prefix_cache=False, prefill_chunk=0, device="cpu")
    args.update(kw)
    return TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), **args)


def _ref_engine(rcfg, rparams, **kw):
    args = dict(num_slots=2, max_seq=128, kv_mode="dense",
                prefix_cache=False, prefill_chunk=0)
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


def test_env_default_is_dense_and_equals_the_jax_engine(quote, monkeypatch):
    config, rcfg, rparams, params = quote
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG=config,
                     SERVE_SLOTS="2", SERVE_MAX_SEQ="128", SERVE_WARMUP="16",
                     SERVE_PREFIX="0", SERVE_PREFILL_CHUNK="0").items():
        monkeypatch.setenv(k, v)
    for k in ("SERVE_KV", "SERVE_KV_QUANT", "SERVE_KV_HOST_GB", "SERVE_SPEC",
              "SERVE_DRAFT", "CKPT_DIR", "SERVE_MODELS"):
        monkeypatch.delenv(k, raising=False)
    engine = build_engine_from_env(params=params)
    ref = _ref_engine(rcfg, rparams)
    try:
        assert engine.scheduler.kv_mode == "dense"
        for prompt in PROMPTS:
            got = _context(engine, prompt, max_tokens=32)
            assert got == _ref_context(ref, prompt, max_tokens=32), prompt
        snap = engine.metrics_snapshot()
        assert not any(k.startswith(("serve_kv_", "paged_flash"))
                       for k in snap)
        assert snap["decode_fused_mean_k"] > 1
    finally:
        engine.stop()
        ref.stop()


def test_chunked_and_prefix_admission_equal_the_jax_engine(quote):
    config, rcfg, rparams, params = quote
    kw = dict(prefix_cache=True, prefill_chunk=16)
    engine = _engine(config, params, **kw)
    ref = _ref_engine(rcfg, rparams, **kw)
    try:
        engine.warmup((16, 32), background=False)
        ref.warmup((16, 32))
        prompts = (PROMPTS[2], SUGGEST_PREFIX + "see you at noon?")
        for prompt in prompts:
            got = _context(engine, prompt, max_tokens=24)
            assert got == _ref_context(ref, prompt, max_tokens=24), prompt
        snap = engine.metrics_snapshot()
        assert snap["prefill_chunks_total"] > 0
        assert snap["serve_prefix_admits_total"] >= 1
    finally:
        engine.stop()
        ref.stop()


@pytest.mark.parametrize("nodes", [8, 0], ids=["tree", "linear"])
def test_ngram_spec_equals_spec_off_and_the_jax_engine(quote, nodes):
    config, rcfg, rparams, params = quote
    on = _engine(config, params, spec_k=4, spec_tree_nodes=nodes)
    off = _engine(config, params)
    ref = _ref_engine(rcfg, rparams, spec_k=4, spec_tree_nodes=nodes)
    try:
        for prompt in PROMPTS[:2]:
            got = _context(on, prompt, max_tokens=40)
            assert got == _context(off, prompt, max_tokens=40), prompt
            assert got == _ref_context(ref, prompt, max_tokens=40), prompt
        snap = on.metrics_snapshot()
        assert snap["serve_spec_accepted_total"] > 0
        assert snap["serve_spec_accepted_per_dispatch"] > 1
    finally:
        on.stop()
        off.stop()
        ref.stop()


def test_dense_refusals(monkeypatch):
    cfg = get_config("tiny")
    tok = ByteTokenizer(cfg.vocab_size)
    params = {"embed": torch.zeros((cfg.vocab_size, cfg.hidden_size))}
    with pytest.raises(ValueError, match="kv_quant=True needs kv_mode"):
        BatchScheduler(params, cfg, tok, kv_mode="dense", kv_quant=True,
                       device="cpu")
    with pytest.raises(ValueError, match="kv_mode must be dense|paged"):
        BatchScheduler(params, cfg, tok, kv_mode="flat", device="cpu")
    sched = BatchScheduler(llama.init_params_quantized(cfg, device="cpu"),
                           cfg, tok, kv_mode="dense", kv_host_gb=1.0,
                           device="cpu")
    try:
        assert sched.session_list() == {}
    finally:
        sched.stop()
    for k, v in dict(SERVE_DEVICE="cpu", SERVE_WARMUP="0",
                     MODEL_CONFIG="tiny").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("SERVE_KV", raising=False)
    monkeypatch.setenv("SERVE_KV_QUANT", "int8")
    with pytest.raises(SystemExit,
                       match="SERVE_KV_QUANT=int8 requires SERVE_KV=paged"):
        build_engine_from_env()
    monkeypatch.delenv("SERVE_KV_QUANT")
    # The KV tier over the dense cache: a finished session parks at once.
    monkeypatch.setenv("SERVE_KV_HOST_GB", "1")
    engine = build_engine_from_env()
    try:
        assert engine.scheduler.kv_mode == "dense"
        _context(engine, "hello there, an open conversation", max_tokens=4,
                 temperature=0.0)
        deadline = time.monotonic() + 10
        while not engine.session_list() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [m["parked"] for m in engine.session_list().values()] == [
            True]
    finally:
        engine.stop()
    # A prefill-class dense replica: prefill_park retains the prompt
    # minus its last token, parked.
    monkeypatch.setenv("SERVE_REPLICA_CLASS", "prefill")
    engine = build_engine_from_env()
    try:
        meta = engine.prefill_park(GenerateRequest(
            prompt="a prompt for the decode replica", session="d",
            options=GenerateOptions(max_tokens=4)))
        assert meta is not None and meta["key"] == "sid:d"
        assert meta["parked"] is True
    finally:
        engine.stop()
    monkeypatch.delenv("SERVE_KV_HOST_GB")
    monkeypatch.setenv("SERVE_KV", "paged")
    build_engine_from_env().stop()
    monkeypatch.setenv("SERVE_KV", "flat")
    with pytest.raises(SystemExit, match="SERVE_KV must be dense|paged"):
        build_engine_from_env()
