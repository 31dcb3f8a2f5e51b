"""The port's co-pilot UI against the reference's: both in front of the
port's FakeLLM front answer the same bytes (suggestions, the stream's
lines, the degraded strings, a shed passed through, the page and its
config); then the whole co-pilot flow in front of the port's Ollama front
over TorchEngine on the CPU (tiny config, paged int8 pool, prefix cache):
the accepted reply lands in A's inbox through the prefix path."""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

import p2p_llm_chat_tpu.ui as ref_ui
import p2p_llm_chat_tpu_torch.ui as port_ui
from p2p_llm_chat_tpu_torch.directory import DirectoryService
from p2p_llm_chat_tpu_torch.node import ChatNode
from p2p_llm_chat_tpu_torch.serve import engine as port_engine
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
from p2p_llm_chat_tpu_torch.utils.http import (HttpServer, Response, Router,
                                               http_json)

MESSAGES = ["dinner at 8?", "are we still on for lunch tomorrow?",
            "naïve café ☕ at noon"]


def _raw(method: str, url: str, body=None, timeout: float = 30.0):
    """(status, Retry-After, body bytes) of one call; HTTP errors too."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Retry-After"), r.read()
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.headers.get("Retry-After"), e.read()
        finally:
            e.close()


def _pair(ollama_url: str, node_http: str = "http://127.0.0.1:9"):
    return [mod.ChatUI(node_http=node_http, ollama_url=ollama_url,
                       llm_model="llama3.1", addr="127.0.0.1:0").start()
            for mod in (ref_ui, port_ui)]


@pytest.fixture()
def fake_front():
    server = OllamaServer(FakeLLM(), addr="127.0.0.1:0").start()
    yield server
    server.stop()


def test_template_is_the_reference_and_extends_the_engine_prefix():
    assert port_ui.SUGGEST_TEMPLATE == ref_ui.SUGGEST_TEMPLATE
    assert port_ui.SUGGEST_TEMPLATE.format(msg="X") == (
        "You are a helpful assistant. Draft a concise, friendly reply to the "
        "following message:\n\nX\n\nReply:")
    assert port_ui.SUGGEST_TEMPLATE.startswith(port_engine.SUGGEST_PREFIX)
    assert port_ui.LLM_TIMEOUT_S == ref_ui.LLM_TIMEOUT_S


@pytest.mark.parametrize("predict", ["0", "3"])
def test_suggestions_and_stream_lines_are_the_same_bytes(fake_front, predict,
                                                         monkeypatch):
    monkeypatch.setenv("UI_SUGGEST_PREDICT", predict)
    uis = _pair(fake_front.url)
    try:
        assert [u.suggest_predict for u in uis] == [int(predict)] * 2
        for msg in MESSAGES:
            got = [_raw("POST", u.url + "/api/suggest", {"content": msg})
                   for u in uis]
            assert got[0] == got[1]
            sug = json.loads(got[1][2])["suggestion"]
            assert sug.startswith("Thanks") and not sug.startswith("(LLM")
            if predict == "0":
                assert msg in sug
            streams = [_raw("POST", u.url + "/api/suggest/stream",
                            {"content": msg}) for u in uis]
            assert streams[0] == streams[1]
            lines = [json.loads(x) for x in streams[1][2].splitlines()]
            assert lines[-1]["done"] is True
            assert "".join(x["delta"] for x in lines) == sug
        bad = [_raw("POST", u.url + "/api/suggest", None) for u in uis]
        assert bad[0] == bad[1]
    finally:
        for u in uis:
            u.stop()


def test_degraded_strings_with_the_llm_down_or_wrong(fake_front):
    down = _pair("http://127.0.0.1:9")
    directory = DirectoryService(addr="127.0.0.1:0").start()
    wrong = _pair(directory.url)          # answers 404 on /api/generate
    try:
        for uis, want in ((down, "(LLM unavailable: "), (wrong, "(LLM error)")):
            got = [_raw("POST", u.url + "/api/suggest", {"content": "hi"})
                   for u in uis]
            assert got[0] == got[1]
            assert json.loads(got[1][2])["suggestion"].startswith(want)
        got = [_raw("POST", u.url + "/api/suggest/stream", {"content": "hi"})
               for u in down]
        assert got[0] == got[1]
        line = json.loads(got[1][2])
        assert line["error"] is True and line["done"] is True
        assert line["delta"].startswith("(LLM unavailable: ")
    finally:
        for u in down + wrong:
            u.stop()
        directory.stop()


def test_a_shed_passes_through_with_its_retry_after():
    router = Router()
    router.add("POST", "/api/generate", lambda r: Response(
        503, {"error": "server overloaded"}, headers={"Retry-After": "2"}))
    shed = HttpServer(router, "127.0.0.1:0").start()
    uis = _pair(shed.url)
    try:
        got = [_raw("POST", u.url + "/api/suggest/stream", {"content": "hi"})
               for u in uis]
        assert got[0] == got[1]
        assert got[1][0] == 503 and got[1][1] == "2"
        assert "server overloaded" in json.loads(got[1][2])["error"]
        got = [_raw("POST", u.url + "/api/suggest", {"content": "hi"})
               for u in uis]
        assert got[0] == got[1]
        assert json.loads(got[1][2]) == {"suggestion": "(LLM error)"}
    finally:
        for u in uis:
            u.stop()
        shed.stop()


def test_page_config_health_and_node_proxies_are_the_same(fake_front):
    directory = DirectoryService(addr="127.0.0.1:0").start()
    node = ChatNode(username="najy", http_addr="127.0.0.1:0",
                    directory_url=directory.url, bootstrap_addrs="",
                    relay_addrs="", identity_file="", dht_addr="off").start()
    uis = _pair(fake_front.url, node_http=node.http_url)
    dead = _pair(fake_front.url)
    try:
        for method, path, body in (
                ("GET", "/", None), ("GET", "/config.json", None),
                ("GET", "/healthz", None),
                ("GET", "/node/inbox?after=", None),
                ("POST", "/node/send", {"to_username": "nobody",
                                        "content": "x"}),
                ("POST", "/node/send", {"to_username": "najy"})):
            got = [_raw(method, u.url + path, body) for u in uis]
            assert got[0] == got[1], path
        page = _raw("GET", uis[1].url + "/")[2]
        assert page.startswith(b"<!") and b"/api/suggest" in page
        with open(os.path.join(os.path.dirname(port_ui.__file__),
                               "web_static", "index.html"), "rb") as f:
            assert page == f.read()
        me = [json.loads(_raw("GET", u.url + "/node/me")[2]) for u in uis]
        assert me[0] == me[1] and me[1]["peer_id"] == node.host.peer_id
        got = [_raw("GET", u.url + "/node/me") for u in dead]
        assert got[0] == got[1] and got[1][0] == 502
    finally:
        for s in uis + dead + [node, directory]:
            s.stop()


def _wait_inbox(ui_url: str, content: str, timeout: float = 10.0) -> list:
    deadline = time.monotonic() + timeout
    while True:
        _, inbox = http_json("GET", f"{ui_url}/node/inbox?after=",
                             timeout=5.0)
        if any(m["content"] == content for m in inbox):
            return inbox
        assert time.monotonic() < deadline, f"{content!r} never arrived"
        time.sleep(0.02)


def test_copilot_flow_in_front_of_the_port_engine_on_cpu(monkeypatch):
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.synth import quote_params
    torch.set_num_threads(2)
    for k, v in dict(SERVE_BACKEND="torch", SERVE_DEVICE="cpu",
                     MODEL_CONFIG="tiny", SERVE_KV="paged",
                     SERVE_QUANT="int8", SERVE_KV_QUANT="int8",
                     SERVE_PREFIX="1", SERVE_SLOTS="4",
                     UI_SUGGEST_PREDICT="16").items():
        monkeypatch.setenv(k, v)
    # Quote weights: a greedy output of printable bytes, so the accepted
    # suggestion is text (random weights' ids mostly decode to nothing).
    engine = port_engine.build_engine_from_env(params=quote_params(
        get_config("tiny"), seed=0, quant="int8", device="cpu"))
    server = OllamaServer(engine, addr="127.0.0.1:0").start()
    directory = DirectoryService(addr="127.0.0.1:0").start()
    started = [server, directory]
    try:
        deadline = time.monotonic() + 120
        while not engine.ready():
            assert engine.warmup_error is None, engine.warmup_error
            assert time.monotonic() < deadline, "the engine never warmed"
            time.sleep(0.05)
        a, b = (ChatNode(username=n, http_addr="127.0.0.1:0",
                         directory_url=directory.url, bootstrap_addrs="",
                         relay_addrs="", identity_file="",
                         dht_addr="off").start() for n in ("najy", "cannan"))
        started += [a, b]
        ui_a = port_ui.ChatUI(node_http=a.http_url, ollama_url=server.url,
                              addr="127.0.0.1:0").start()
        ui_b = port_ui.ChatUI(node_http=b.http_url, ollama_url=server.url,
                              addr="127.0.0.1:0").start()
        started += [ui_a, ui_b]
        admits0 = engine.metrics_snapshot()["serve_prefix_admits_total"]
        msg = "are we still on for lunch tomorrow?"
        status, sent = http_json("POST", f"{ui_a.url}/node/send",
                                 {"to_username": "cannan", "content": msg},
                                 timeout=15.0)
        assert status == 200 and sent["status"] == "sent"
        inbox = _wait_inbox(ui_b.url, msg)
        status, sug = http_json("POST", f"{ui_b.url}/api/suggest",
                                {"content": inbox[0]["content"]},
                                timeout=60.0)
        suggestion = sug["suggestion"]
        assert status == 200 and suggestion and not suggestion.startswith(
            "(LLM")
        # The UI's suggestion is the server's greedy answer to the template.
        status, direct = http_json("POST", f"{server.url}/api/generate", {
            "model": "llama3.1", "stream": False,
            "prompt": port_ui.SUGGEST_TEMPLATE.format(msg=msg),
            "options": {"num_predict": 16}}, timeout=60.0)
        assert status == 200 and suggestion == direct["response"].strip()
        _, _, raw = _raw("POST", f"{ui_b.url}/api/suggest/stream",
                         {"content": msg}, timeout=60.0)
        lines = [json.loads(x) for x in raw.splitlines()]
        assert lines[-1]["done"] is True
        assert "".join(x["delta"] for x in lines) == direct["response"]
        status, _ = http_json("POST", f"{ui_b.url}/node/send",
                              {"to_username": "najy", "content": suggestion},
                              timeout=15.0)
        assert status == 200
        back = _wait_inbox(ui_a.url, suggestion)
        assert [m["content"] for m in back] == [suggestion]
        admits = (engine.metrics_snapshot()["serve_prefix_admits_total"]
                  - admits0)
        assert admits >= 2
    finally:
        for s in reversed(started):
            s.stop()
        engine.stop()
