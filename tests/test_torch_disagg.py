"""Disaggregated prefill on the port (serve/disagg.py, the scheduler's
``prefill_park`` and ``POST /admin/disagg/prefill``), against the
reference, on the CPU.

- ``replica_class_from_env`` equals the reference's on the same settings
  (the value, or both exit), and the front advertises the class on
  ``/readyz`` and ``/metrics``.
- Both legs below run over the int8 pool and over the dense cache.
- The engine-level leg of the reference's
  ``test_disagg_byte_identity_and_failure_degradation``: ``prefill_park``
  on engine A retains exactly ``ids[:-1]``; export -> import on B; the
  request on B WAKES and its greedy output is byte-identical to B's own
  never-disaggregated run, turn 2 included; a prompt too short to leave
  an indexable suffix parks nothing.
- The reference's ``drive_handoff`` (its router-side HTTP choreography)
  between two port fronts, a prefill-class and a decode-class one: the
  session moves, the source forgets it on the ack, the decode front
  wakes it byte-identically to a cold run; a front with no KV tier
  answers 501 (``HandoffUnsupported``), an unindexable request 422 (no
  handoff), a draining prefill front 503 (no handoff).
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.serve import disagg as ref_disagg
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve import disagg
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import (FakeLLM, GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)

RCFG = ref_config("tiny")
CFG = get_config("tiny")
TOK = ByteTokenizer(CFG.vocab_size)
PROMPT1 = "hello there, how are you doing today my good friend?"
PROMPT2 = " tell me one more thing before we finish?"
ANON = "an entirely anonymous conversation opener, long enough to index!"


@pytest.mark.parametrize("value", [None, "prefill", "decode", "mixed",
                                   "Decode ", " PREFILL", "gpu", ""])
def test_replica_class_from_env_equals_the_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("SERVE_REPLICA_CLASS", raising=False)
    else:
        monkeypatch.setenv("SERVE_REPLICA_CLASS", value)
    try:
        want = ref_disagg.replica_class_from_env()
    except SystemExit:
        with pytest.raises(SystemExit):
            disagg.replica_class_from_env()
        return
    assert disagg.replica_class_from_env() == want
    assert disagg.REPLICA_CLASSES == ref_disagg.REPLICA_CLASSES


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()


def test_front_advertises_its_class(monkeypatch):
    monkeypatch.setenv("SERVE_REPLICA_CLASS", "decode")
    srv = OllamaServer(FakeLLM(), addr="127.0.0.1:0").start()
    other = OllamaServer(FakeLLM(), addr="127.0.0.1:0",
                         replica_class="prefill").start()
    try:
        status, body = _get(srv.url + "/readyz")
        assert status == 200 and json.loads(body)["class"] == "decode"
        assert 'serve_replica_class{class="decode"} 1' in _get(
            srv.url + "/metrics")[1]
        assert json.loads(_get(other.url + "/readyz")[1])["class"] == \
            "prefill"
    finally:
        srv.stop()
        other.stop()
    with pytest.raises(ValueError):
        OllamaServer(FakeLLM(), addr="127.0.0.1:0", replica_class="bogus")


# -- engines -----------------------------------------------------------------------

def run(engine, prompt, session="", max_tokens=8, ctx=()):
    stats = RequestStats()
    req = GenerateRequest(prompt=prompt, session=session, context=tuple(ctx),
                          options=GenerateOptions(max_tokens=max_tokens,
                                                  temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def params():
    rparams = ref_llama.init_params(RCFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, rparams),
                             device="cpu")


def make_engine(params, host_gb=1.0, kv_mode="paged"):
    eng = TorchEngine(params, CFG, TOK, num_slots=2, max_seq=256,
                      page_size=64, kv_quant=kv_mode == "paged",
                      prefix_cache=False, kv_host_gb=host_gb, kv_idle_s=1e9,
                      kv_mode=kv_mode, device="cpu")
    eng.scheduler.warmup((64, 128))
    return eng


@pytest.mark.model
@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_disagg_engine_leg_byte_identity(params, kv_mode):
    a, b = (make_engine(params, kv_mode=kv_mode),     # prefill, decode
            make_engine(params, kv_mode=kv_mode))
    try:
        o1, os_ = run(b, PROMPT1, "oracle")
        o2, _ = run(b, PROMPT2, "oracle", ctx=os_.context)
        meta = a.prefill_park(GenerateRequest(
            prompt=PROMPT1, session="m",
            options=GenerateOptions(max_tokens=8, temperature=0.0, seed=1)))
        assert meta is not None and meta["key"] == "sid:m"
        assert meta["len"] == len(TOK.encode(PROMPT1, add_bos=True)) - 1
        # A dense session parks as its throwaway generation finishes.
        assert meta["parked"] is (kv_mode == "dense")
        payload = a.session_export("sid:m")
        assert payload is not None
        assert "sid:m" in a.scheduler._tier.sessions_meta()   # retained
        assert b.session_import(payload) is not None
        waked0 = b.scheduler.metrics_snapshot()["kv_waked_total"]
        m1, s1 = run(b, PROMPT1, "m")
        assert m1 == o1, "disagg turn 1 diverged from the oracle"
        assert b.scheduler.metrics_snapshot()["kv_waked_total"] == waked0 + 1
        m2, _ = run(b, PROMPT2, "m", ctx=s1.context)
        assert m2 == o2, "disagg turn 2 diverged from the oracle"
        assert a.session_forget("sid:m") is True
        # Anonymous: keyed by the prompt head.
        meta = a.prefill_park(GenerateRequest(
            prompt=ANON, options=GenerateOptions(max_tokens=8)))
        assert meta is not None and meta["key"].startswith("head:")
        # Too short to leave an indexable suffix: nothing parks.
        assert a.prefill_park(GenerateRequest(
            prompt="x", options=GenerateOptions(max_tokens=4))) is None
    finally:
        a.stop()
        b.stop()


@pytest.mark.model
@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_reference_drive_handoff_between_port_fronts(params, kv_mode):
    a, b = (make_engine(params, kv_mode=kv_mode),
            make_engine(params, kv_mode=kv_mode))
    plain = make_engine(params, host_gb=0.0, kv_mode=kv_mode)
    fronts = []
    try:
        fronts = [OllamaServer(a, addr="127.0.0.1:0",
                               replica_class="prefill").start(),
                  OllamaServer(b, addr="127.0.0.1:0",
                               replica_class="decode").start(),
                  OllamaServer(plain, addr="127.0.0.1:0").start()]
        pre, dec, no_tier = (f.url for f in fronts)
        o1, _ = run(plain, PROMPT1)
        body = {"model": "tiny", "prompt": PROMPT1, "stream": False,
                "session": "rr",
                "options": {"num_predict": 8, "temperature": 0.0,
                            "seed": 1}}
        meta = ref_disagg.drive_handoff(pre, dec, "/api/generate", body,
                                        session="rr")
        assert meta is not None and meta["key"] == "sid:rr"
        assert "sid:rr" not in a.scheduler._tier.sessions_meta(), \
            "the source kept its copy after the ack"
        assert b.scheduler._tier.sessions_meta()["sid:rr"]["parked"]
        req = urllib.request.Request(
            f"{dec}/api/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            rec = json.loads(r.read())
        assert rec["response"] == o1, "the handed-off request diverged"
        assert b.scheduler.metrics_snapshot()["kv_waked_total"] == 1
        # Chat bodies ride it too (the prompt rendered as /api/chat would).
        chat = {"model": "tiny", "messages": [
            {"role": "user", "content": PROMPT1 + PROMPT2}],
            "options": {"num_predict": 4}}
        assert ref_disagg.drive_handoff(pre, dec, "/api/chat", chat,
                                        session="chat") is not None
        # Unindexable: 422, no handoff.
        short = {"prompt": "x", "options": {"num_predict": 2}}
        assert ref_disagg.drive_handoff(pre, dec, "/api/generate",
                                        short) is None
        # No KV tier on the prefill side: 501, never ask again.
        with pytest.raises(ref_disagg.HandoffUnsupported):
            ref_disagg.drive_handoff(no_tier, dec, "/api/generate", body)
        # A draining prefill front sheds: 503, no handoff.
        urllib.request.urlopen(urllib.request.Request(
            f"{pre}/admin/drain", data=b"{}", method="POST"), timeout=10)
        assert ref_disagg.drive_handoff(pre, dec, "/api/generate",
                                        body) is None
    finally:
        for f in fronts:
            f.stop()
        for e in (a, b, plain):
            e.stop()
