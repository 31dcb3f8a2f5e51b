"""The port's front and engine env surface against the reference's.

- Drain: ``POST /admin/drain`` / ``/admin/undrain`` on both fronts over
  FakeLLM answer with the same status codes, JSON and ``Retry-After``
  headers, for the drain calls, ``/readyz`` and a generate in between; the
  engine's scheduler drains and undrains with them.
- ``SERVE_ADMIT_CHUNK`` caps the rows of each admission prefill (the
  reference's burst-admission width) and is refused below 1.
- ``SERVE_WARMUP``'s default is the reference's ``128,256``.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from p2p_llm_chat_tpu.serve.api import OllamaServer as RefServer
from p2p_llm_chat_tpu.serve.backend import FakeLLM as RefFake
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.llama import init_params_quantized
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import (FakeLLM, GenerateOptions,
                                                  GenerateRequest,
                                                  OverloadError)
from p2p_llm_chat_tpu_torch.serve.engine import (TorchEngine,
                                                 build_engine_from_env)
from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)


def _call(method: str, url: str, body=None) -> tuple[int, dict, str]:
    """(status, JSON body, Retry-After header or '') of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return (r.status, json.loads(r.read().decode()),
                    r.headers.get("Retry-After", ""))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), \
            e.headers.get("Retry-After", "")


_GENERATE = {"prompt": "hi", "stream": False, "options": {"num_predict": 2}}
_STEPS = [("GET", "/readyz", None), ("POST", "/admin/drain", {}),
          ("GET", "/readyz", None), ("POST", "/api/generate", _GENERATE),
          ("POST", "/admin/undrain", {}), ("GET", "/readyz", None),
          ("POST", "/api/generate", _GENERATE)]


def test_drain_and_undrain_answer_as_the_reference_front():
    ref = RefServer(RefFake(), addr="127.0.0.1:0").start()
    port = OllamaServer(FakeLLM(), addr="127.0.0.1:0").start()
    try:
        for method, path, body in _STEPS:
            want = _call(method, ref.url + path, body)
            got = _call(method, port.url + path, body)
            assert got[0] == want[0], (path, got, want)
            assert sorted(got[1]) == sorted(want[1]), (path, got, want)
            assert got[2] == want[2], (path, got, want)
            if path != "/api/generate":
                assert got[1] == want[1], (path, got, want)
        assert _call("GET", port.url + "/readyz")[1]["status"] == "ready"
    finally:
        ref.stop()
        port.stop()


def test_front_drain_reaches_the_engine_and_reverses():
    cfg = get_config("tiny")
    engine = TorchEngine(init_params_quantized(cfg, device="cpu"), cfg,
                         ByteTokenizer(cfg.vocab_size), num_slots=1,
                         max_seq=64, page_size=16, prefix_cache=False,
                         kv_mode="paged", device="cpu")
    srv = OllamaServer(engine, addr="127.0.0.1:0").start()
    try:
        assert _call("POST", srv.url + "/admin/drain", {})[0] == 200
        assert engine.draining() and not engine.ready()
        with pytest.raises(OverloadError, match="draining"):
            engine.generate_stream(GenerateRequest(prompt="x"))
        status, body, retry = _call("GET", srv.url + "/readyz")
        assert (status, body["status"], retry) == (503, "draining", "5")
        assert _call("POST", srv.url + "/admin/undrain", {})[0] == 200
        assert not engine.draining() and engine.ready()
        status, body, _ = _call("POST", srv.url + "/api/generate", _GENERATE)
        assert status == 200 and body["done"] is True
    finally:
        srv.stop()
        engine.stop()


def _admission_prefills(engine, prompts) -> list[int]:
    """Rows of each admission prefill for ``prompts`` submitted as one
    burst while the scheduler thread is held, so they queue together."""
    sched = engine.scheduler
    rows: list[int] = []
    inner = sched._admit_chunk

    def counted(chunk, *args, **kwargs):
        rows.append(len(chunk))
        return inner(chunk, *args, **kwargs)

    sched._admit_chunk = counted
    hold = threading.Event()
    sched.post_on_loop(hold.wait)
    streams = [engine.generate_stream(GenerateRequest(
        prompt=p, options=GenerateOptions(max_tokens=2))) for p in prompts]
    hold.set()
    for s in streams:
        "".join(s)
    return rows


@pytest.mark.parametrize("admit,want", [("1", [1, 1, 1, 1]), ("3", [3, 1]),
                                        ("", [4])])
def test_serve_admit_chunk_caps_admission_rows(admit, want, monkeypatch):
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny",
                     SERVE_KV="paged",
                     SERVE_SLOTS="4", SERVE_MAX_SEQ="64", SERVE_WARMUP="0",
                     SERVE_PREFIX="0", SERVE_ADMIT_CHUNK=admit).items():
        monkeypatch.setenv(k, v)
    engine = build_engine_from_env()
    try:
        assert _admission_prefills(engine, ["ab", "cd", "ef", "gh"]) == want
    finally:
        engine.stop()


def test_admit_chunk_below_one_is_refused(monkeypatch):
    cfg = get_config("tiny")
    params = init_params_quantized(cfg, device="cpu")
    with pytest.raises(ValueError, match="admit_chunk must be >= 1"):
        BatchScheduler(params, cfg, ByteTokenizer(cfg.vocab_size),
                       admit_chunk=0, device="cpu")
    monkeypatch.setenv("SERVE_DEVICE", "cpu")
    monkeypatch.setenv("SERVE_WARMUP", "0")
    monkeypatch.setenv("SERVE_ADMIT_CHUNK", "-2")
    with pytest.raises(ValueError, match="admit_chunk must be >= 1"):
        build_engine_from_env()


def test_serve_warmup_default_is_the_reference_buckets(monkeypatch):
    seen = []
    monkeypatch.setattr(TorchEngine, "warmup",
                        lambda self, buckets=(): seen.append(buckets))
    monkeypatch.setenv("SERVE_DEVICE", "cpu")
    monkeypatch.delenv("SERVE_WARMUP", raising=False)
    engine = build_engine_from_env()
    engine.stop()
    assert seen == [(128, 256)]
