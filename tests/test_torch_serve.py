"""The port's serving stack on the CPU: the Ollama front over the port's
engine (``tiny``, paged pool, int8 weights, int8 KV; ``tiny-moe`` with
int4 weights), greedy output equal to the reference engine's on the same
weights (llama and mixtral, int8 and int4), and the device rule.

Greedy ``context`` ids are compared token for token on the
quote-workload weights (models/synth.quote_params — clear argmax
margins), with the reference engine at SERVE_PREFIX=0 SERVE_FUSE=1
SERVE_PREFILL_CHUNK=0 (features the port does not run yet; none changes
the reference's output).
"""

import json
import socket
import time
import urllib.request

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
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.llama import init_params_quantized
from p2p_llm_chat_tpu_torch.ops.paged_kv import PagedKVCache
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import (TorchEngine,
                                                 build_engine_from_env)
from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)
pytestmark = pytest.mark.model


def _post(url: str, body: dict) -> tuple[int, str]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read().decode()


def _get(url: str) -> tuple[int, str]:
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module")
def server():
    mp = pytest.MonkeyPatch()
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny",
                     SERVE_KV="paged", SERVE_QUANT="int8",
                     SERVE_KV_QUANT="int8", SERVE_SLOTS="4",
                     SERVE_MAX_SEQ="128", SERVE_WARMUP="16").items():
        mp.setenv(k, v)
    engine = build_engine_from_env()
    srv = OllamaServer(engine, addr="127.0.0.1:0").start()
    deadline = time.monotonic() + 60
    while not engine.ready() and time.monotonic() < deadline:
        time.sleep(0.02)
    yield srv, engine
    srv.stop()
    engine.stop()
    mp.undo()


def test_generate_non_stream(server):
    srv, _ = server
    status, body = _post(srv.url + "/api/generate",
                         {"prompt": "hello", "stream": False,
                          "options": {"num_predict": 6}})
    rec = json.loads(body)
    assert status == 200 and rec["done"] is True
    assert 0 < rec["eval_count"] <= 6
    assert rec["prompt_eval_count"] == 6            # BOS + 5 bytes
    assert rec["context"][:6] == [256] + list(b"hello")
    assert len(rec["context"]) == 6 + rec["eval_count"]
    # Wire format: the reference's keys, json.dumps default spacing.
    assert body.startswith('{"model": "tiny", "created_at": ')
    for key in ("done_reason", "total_duration", "load_duration",
                "prompt_eval_duration", "eval_duration", "response"):
        assert key in rec


def test_generate_stream_ndjson(server):
    srv, _ = server
    status, body = _post(srv.url + "/api/generate",
                         {"prompt": "hi", "options": {"num_predict": 5,
                                                      "temperature": 0.7,
                                                      "seed": 4}})
    lines = [json.loads(x) for x in body.splitlines()]
    assert status == 200
    assert all(x["done"] is False for x in lines[:-1])
    assert lines[-1]["done"] is True and 0 < lines[-1]["eval_count"] <= 5
    assert "context" in lines[-1]


def test_chat_tags_show_health_ready_metrics(server):
    srv, engine = server
    status, body = _post(srv.url + "/api/chat",
                         {"messages": [{"role": "user", "content": "yo"}],
                          "stream": False, "options": {"num_predict": 3}})
    rec = json.loads(body)
    assert status == 200 and rec["message"]["role"] == "assistant"
    assert 0 < rec["eval_count"] <= 3 and "context" not in rec
    tags = json.loads(_get(srv.url + "/api/tags")[1])
    assert [m["name"] for m in tags["models"]] == ["tiny"]
    show = json.loads(_post(srv.url + "/api/show", {"model": "tiny"})[1])
    assert show["model_info"]["llama.block_count"] == 2
    assert json.loads(_get(srv.url + "/healthz")[1]) == {"status": "ok"}
    assert json.loads(_get(srv.url + "/readyz")[1]) == {"status": "ready",
                                                        "class": "mixed"}
    text = _get(srv.url + "/metrics")[1]
    for series in ("serve_requests_total", "serve_batch_occupancy",
                   "serve_kv_free_pages", 'model_weight_bytes{quant="int8"}',
                   "serve_decode_ticks_total"):
        assert series in text
    # Every request finished: the pool drained back to total.
    snap = engine.metrics_snapshot()
    assert snap["serve_kv_free_pages"] == snap["serve_kv_total_pages"]


def _greedy_contexts_agree(prompts, config="tiny", quant="int8",
                           **opts) -> None:
    """Each prompt through the reference engine and the port's, one at a
    time, on the same quote weights: the greedy ``context`` ids agree."""
    cfg = ref_config(config)
    params = quote_params(cfg, jax.random.PRNGKey(5), quantized=True,
                          quant=quant)
    ref_engine = TPUEngine(params, cfg, RefByteTokenizer(cfg.vocab_size),
                           num_slots=2, max_seq=128, kv_mode="paged",
                           page_size=16, kv_quant=True, prefix_cache=False,
                           decode_fuse_max=1, prefill_chunk=0)
    engine = TorchEngine(params_from_numpy(jax.tree.map(np.asarray, params),
                                           device="cpu"),
                         get_config(config), ByteTokenizer(cfg.vocab_size),
                         num_slots=2, max_seq=128, page_size=16,
                         kv_quant=True, kv_mode="paged", device="cpu")
    try:
        for prompt in prompts:
            ref_stats, stats = RefStats(), RequestStats()
            ref_collect(ref_engine, RefRequest(
                prompt=prompt, options=RefOptions(max_tokens=16, **opts)),
                ref_stats)
            collect(engine, GenerateRequest(
                prompt=prompt, options=GenerateOptions(max_tokens=16,
                                                       **opts)), stats)
            assert stats.completion_tokens > 0
            assert stats.context == ref_stats.context
    finally:
        ref_engine.stop()
        engine.stop()


def test_greedy_context_matches_reference_engine():
    _greedy_contexts_agree(("abc", "the quick brown fox"))


@pytest.mark.parametrize("config,quant", [("tiny-moe", "int4"),
                                          ("tiny-moe", "int8"),
                                          ("tiny", "int4")])
def test_greedy_context_matches_reference_engine_int4_and_moe(config, quant):
    _greedy_contexts_agree(("abc", "the quick brown fox"), config, quant)


def test_penalised_greedy_context_matches_reference_engine():
    """The scheduler's device penalty ring (prompt tail, then each emitted
    token at its context position) against the reference's: a prompt
    longer than the 64-token ring, so it wraps, and a strong penalty that
    changes the greedy stream."""
    _greedy_contexts_agree(("aaaa", "the quick brown fox jumps " * 4),
                           repeat_penalty=1.5)


def test_gpu_default_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SERVE_DEVICE", raising=False)
    monkeypatch.setenv("MODEL_CONFIG", "tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine_from_env()
    cfg = get_config("tiny")
    tok = ByteTokenizer(cfg.vocab_size)
    params = init_params_quantized(cfg, device="cpu")
    for make in (lambda: init_params_quantized(cfg),
                 lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
                 lambda: PagedKVCache.create(cfg, 1, 2, 16),
                 lambda: BatchScheduler(params, cfg, tok),
                 lambda: TorchEngine(params, cfg, tok)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# Features of the reference that the port now serves; a missing
# checkpoint directory raises the reference's FileNotFoundError; any
# other would exit with "not ported" (SERVE_TP serves over its own ranks,
# tests/test_torch_tp_engine.py, with the KV tier too,
# tests/test_torch_tp_tier.py, and with SERVE_MODELS every tag on them,
# tests/test_torch_tp_multi.py: its world is left and its follower
# reaped by close(), its rank capped at one thread). SERVE_PROFILE_PORT
# starts its listener on a free port in place of the case's, and stop()
# closes it. The KV layout is pinned to SERVE_KV=paged (the KV tier needs
# it) unless the case names it.
_PORTED = ({"SERVE_SPEC": "2"}, {"SERVE_QUANT": "int4"},
           {"MODEL_CONFIG": "tiny-moe"}, {"SERVE_KV_HOST_GB": "1"},
           {"SERVE_MODELS": "a=tiny"}, {"SERVE_KV": "dense"},
           {"SERVE_SPEC": "2", "SERVE_DRAFT": "tiny"},
           {"SERVE_PROFILE_PORT": "9999"},
           {"SERVE_TP": "2", "SERVE_MODELS": "a=tiny"})


@pytest.mark.parametrize("env", [{"SERVE_SPEC": "2"},
                                 {"SERVE_KV_HOST_GB": "1"},
                                 {"SERVE_TP": "2", "SERVE_MODELS": "a=tiny"},
                                 {"SERVE_MODELS": "a=tiny"},
                                 {"CKPT_DIR": "/nonexistent"},
                                 {"SERVE_PROFILE_PORT": "9999"},
                                 {"SERVE_QUANT": "int4"},
                                 {"SERVE_KV": "dense"},
                                 {"MODEL_CONFIG": "tiny-moe"},
                                 {"SERVE_SPEC": "2", "SERVE_DRAFT": "tiny"}])
def test_features_of_later_slices_fail_loudly(env, monkeypatch):
    monkeypatch.setenv("SERVE_DEVICE", "cpu")
    monkeypatch.setenv("SERVE_WARMUP", "0")
    monkeypatch.setenv("SERVE_KV", "paged")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if env.get("SERVE_KV") == "dense":
        # The module's server fixture sets an int8 pool, which a dense
        # cache refuses.
        monkeypatch.delenv("SERVE_KV_QUANT", raising=False)
    if "SERVE_PROFILE_PORT" in env:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        monkeypatch.setenv("SERVE_PROFILE_PORT", str(port))
    threads = torch.get_num_threads()
    if "SERVE_TP" in env:
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if env in _PORTED:
        engine = build_engine_from_env()
        if "SERVE_PROFILE_PORT" in env:
            assert engine.profile_server is not None
        engine.stop()
        engine.close()
        torch.set_num_threads(threads)
        if "SERVE_PROFILE_PORT" in env:
            with pytest.raises(ConnectionRefusedError):
                socket.create_connection(("127.0.0.1", port),
                                         timeout=5).close()
        return
    if "CKPT_DIR" in env:
        with pytest.raises(FileNotFoundError):
            build_engine_from_env()
        return
    with pytest.raises(SystemExit, match="not ported"):
        build_engine_from_env()


def test_env_built_moe_int4_engine_serves(monkeypatch):
    """The CPU drive of the README: tiny-moe, int4 weights, int8 paged
    KV, built from the env and answering through the Ollama front."""
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny-moe",
                     SERVE_QUANT="int4", SERVE_KV="paged",
                     SERVE_KV_QUANT="int8", SERVE_SLOTS="2",
                     SERVE_MAX_SEQ="128", SERVE_WARMUP="16").items():
        monkeypatch.setenv(k, v)
    engine = build_engine_from_env()
    srv = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        deadline = time.monotonic() + 60
        while not engine.ready() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.ready()
        status, body = _post(srv.url + "/api/generate",
                             {"prompt": "hello", "stream": False,
                              "options": {"num_predict": 6}})
        rec = json.loads(body)
        assert status == 200 and rec["done"] is True
        assert 0 < rec["eval_count"] <= 6
        show = json.loads(_post(srv.url + "/api/show", {})[1])
        assert show["model_info"]["general.architecture"] == "mixtral"
        text = _get(srv.url + "/metrics")[1]
        assert 'model_weight_bytes{quant="int4"}' in text
    finally:
        srv.stop()
        engine.stop()
