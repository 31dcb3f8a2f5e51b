"""The live profiler server (``SERVE_PROFILE_PORT``, obs/profile_server.py)
on the CPU: an engine built from the env (tiny, chunked prefill at 16)
answers ``POST /profile`` on its own port.

- A capture taken while a request runs returns a gzip Chrome trace
  holding the scheduler's ``sched.tick`` ranges, and ``sched.chunk`` for
  a prompt longer than the chunk (the profiler starts and stops on the
  loop's thread, so its ranges are in the trace), and the loop's time in
  starting and stopping it in ``X-Profile-Loop-Ms``.
- A second capture while one runs answers 409; a missing, zero, too
  long or non-numeric duration answers 400; an unknown model 404.
- ``engine.stop()`` closes the listener.
"""

import gzip
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest)
from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env

pytestmark = pytest.mark.model
# A prompt of 70 bytes: a 128 bucket, eight chunks of 16.
LONG = "lunch moved to one o'clock, the room is on the third floor, see you!!"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _profile(url: str, body, timeout: float = 60, headers=None
             ) -> tuple[int, bytes]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + "/profile", data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if headers is not None:
                headers.update(r.headers)
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _names(trace: bytes) -> set:
    events = json.loads(gzip.decompress(trace))["traceEvents"]
    return {e.get("name") for e in events}


@pytest.fixture(scope="module")
def engine():
    mp = pytest.MonkeyPatch()
    port = _free_port()
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny",
                     SERVE_QUANT="int8", SERVE_SLOTS="2", SERVE_MAX_SEQ="256",
                     SERVE_PREFILL_CHUNK="16", SERVE_WARMUP="16",
                     SERVE_PROFILE_PORT=str(port)).items():
        mp.setenv(k, v)
    for k in ("SERVE_TP", "SERVE_MODELS", "SERVE_COORDINATOR", "CKPT_DIR",
              "SERVE_KV_HOST_GB"):
        mp.delenv(k, raising=False)
    eng = build_engine_from_env()
    deadline = time.monotonic() + 60
    while not eng.ready():
        assert eng.warmup_error is None and time.monotonic() < deadline
        time.sleep(0.02)
    try:
        yield eng, f"http://127.0.0.1:{port}", port
    finally:
        eng.stop()
        mp.undo()


def _generate(eng, prompt: str, n: int) -> str:
    return "".join(eng.generate_stream(GenerateRequest(
        prompt=prompt, options=GenerateOptions(max_tokens=n,
                                               temperature=0.0))))


def test_capture_during_a_request_names_the_loops_ops(engine):
    eng, url, _ = engine
    got: dict = {}
    head: dict = {}
    cap = threading.Thread(target=lambda: got.update(
        res=_profile(url, {"duration_ms": 2000}, headers=head)))
    cap.start()
    time.sleep(0.3)
    texts = [_generate(eng, LONG, 24), _generate(eng, "hi", 24)]
    cap.join(60)
    assert not cap.is_alive()
    status, body = got["res"]
    assert status == 200, body[:300]
    names = _names(body)
    assert "sched.tick" in names and "sched.chunk" in names, sorted(
        n for n in names if n and n.startswith("sched."))
    assert "sched.admit" in names
    # The loop's time in starting and stopping the profiler.
    assert float(head["X-Profile-Loop-Ms"]) >= 0
    assert all(isinstance(t, str) for t in texts)
    assert eng.metrics_snapshot()["prefill_chunks_total"] >= 8


def test_a_second_capture_meanwhile_is_refused(engine):
    _, url, _ = engine
    got: dict = {}
    first = threading.Thread(target=lambda: got.update(
        first=_profile(url, {"duration_ms": 1500})))
    first.start()
    time.sleep(0.3)
    status, body = _profile(url, {"duration_ms": 10})
    first.join(60)
    assert status == 409, body
    assert got["first"][0] == 200
    # Free again once the first returned.
    assert _profile(url, {"duration_ms": 5})[0] == 200


@pytest.mark.parametrize("body", [{}, {"duration_ms": 0},
                                  {"duration_ms": 30001},
                                  {"duration_ms": "100"},
                                  {"duration_ms": True}, b"not json"],
                         ids=["missing", "zero", "too-long", "string",
                              "bool", "not-json"])
def test_a_bad_duration_is_refused(engine, body):
    _, url, _ = engine
    status, text = _profile(url, body)
    assert status == 400, text
    assert b"duration_ms" in text or b"JSON" in text


@pytest.mark.parametrize("model", ["nope", ["tiny"]], ids=["unknown",
                                                         "not-a-name"])
def test_an_unknown_model_is_not_found(engine, model):
    _, url, _ = engine
    assert _profile(url, {"duration_ms": 5, "model": model})[0] == 404


def test_stop_closes_the_listener(monkeypatch):
    port = _free_port()
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny", SERVE_SLOTS="2",
                     SERVE_MAX_SEQ="128", SERVE_WARMUP="0",
                     SERVE_PROFILE_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    for k in ("SERVE_TP", "SERVE_MODELS", "SERVE_COORDINATOR", "CKPT_DIR"):
        monkeypatch.delenv(k, raising=False)
    eng = build_engine_from_env()
    try:
        assert eng.profile_server is not None
        assert _profile(f"http://127.0.0.1:{port}", {})[0] == 400
    finally:
        eng.stop()
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
