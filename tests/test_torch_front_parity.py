"""The port's Ollama front against the reference's, route by route.

- Both fronts over FakeLLM: every ``(method, path)`` the reference's
  router registers answers on the port with the reference's status code
  and the same JSON shape (key sets, nested), except an explicit set of
  routes of features the port does not serve yet (the prefix, session
  and disaggregated-prefill admin routes). The test asserts that set
  exactly, so it cannot grow silently.
- The error and shed paths: ``/api/ps``, ``/api/version``, ``GET`` and
  ``HEAD /``, the model-management 501s, the embed 400s, and the drain
  503 of the embed routes, which moves no shed counter (``count=False``).
- On the ``tiny`` engines of both packages, after warmup and one
  request, the port's ``/metrics`` series are a superset of the
  reference's, minus a named speculation / KV-tier set; with speculation
  on (``spec_k`` 4, tree verify), the two fronts' ``serve_spec_*``
  series are the same names with the same labels.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.serve.api import OllamaServer as RefServer
from p2p_llm_chat_tpu.serve.backend import FakeLLM as RefFake
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu.utils import failpoints as ref_fp
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils import failpoints as fp

torch.set_num_threads(2)

# Routes of features the port does not serve yet (ROADMAP Queue A: the
# prefix export/import tier, session migration, disaggregated prefill).
EXCLUDED = {
    ("GET", "/admin/prefix"), ("GET", "/admin/prefix/export"),
    ("POST", "/admin/prefix/import"), ("GET", "/admin/session"),
    ("GET", "/admin/session/export"), ("POST", "/admin/session/import"),
    ("POST", "/admin/session/forget"), ("POST", "/admin/session/park_all"),
    ("POST", "/admin/disagg/prefill"),
}

# Each route the port shares with the reference, with the body it is
# called with.
ROUTES = {
    ("POST", "/api/generate"): {"prompt": "hi", "stream": False,
                                "options": {"num_predict": 3}},
    ("POST", "/api/chat"): {"messages": [{"role": "user", "content": "hi"}],
                            "stream": False, "options": {"num_predict": 3}},
    ("POST", "/api/embed"): {"input": ["a", "b c"]},
    ("POST", "/api/embeddings"): {"prompt": "a"},
    ("GET", "/api/tags"): None,
    ("POST", "/api/show"): {},
    ("GET", "/api/ps"): None,
    ("GET", "/api/version"): None,
    ("POST", "/api/pull"): {}, ("POST", "/api/push"): {},
    ("POST", "/api/create"): {}, ("POST", "/api/copy"): {},
    ("DELETE", "/api/delete"): {},
    ("GET", "/"): None,
    ("HEAD", "/"): None,
    ("GET", "/metrics"): None,
    ("GET", "/healthz"): None,
    ("GET", "/readyz"): None,
    ("POST", "/admin/drain"): {},
    ("POST", "/admin/undrain"): {},
    ("GET", "/admin/trace"): None,
    ("POST", "/admin/trace/dump"): {},
}

# Reference series that a default engine does not export: speculation's
# (held by test_spec_series_equal_the_references below) and the KV
# tier's (not ported yet).
SPEC_TIER_PREFIXES = ("serve_spec_", "spec_", "kv_")


def _call(method: str, url: str, body=None, raw: bytes = None):
    """(status, content type, body bytes, headers) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read(), \
                r.headers
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.get("Content-Type", ""), e.read(), \
                e.headers


def _shape(obj):
    """A JSON value's structure: dict keys (recursively), a list's first
    element, and scalar types (int and float as one)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    if isinstance(obj, bool) or obj is None:
        return type(obj).__name__
    if isinstance(obj, (int, float)):
        return "number"
    return type(obj).__name__


def _types(metrics_text: str) -> set:
    return {line.split()[2] for line in metrics_text.splitlines()
            if line.startswith("# TYPE ")}


@pytest.fixture(scope="module")
def fronts():
    ref = RefServer(RefFake(), addr="127.0.0.1:0").start()
    port = OllamaServer(FakeLLM(), addr="127.0.0.1:0").start()
    yield ref, port
    ref.stop()
    port.stop()


def test_the_port_serves_every_reference_route_but_the_named_ones(fronts):
    ref, port = fronts
    ref_routes = set(ref.router._routes)
    port_routes = set(port.router._routes)
    assert ref_routes - port_routes == EXCLUDED
    assert port_routes - ref_routes == set()
    assert port_routes == set(ROUTES)


@pytest.mark.parametrize("route", sorted(ROUTES), ids="{0[0]} {0[1]}".format)
def test_route_answers_as_the_reference(fronts, route):
    ref, port = fronts
    method, path = route
    body = ROUTES[route]
    if path == "/metrics":
        # failpoint_hits_total shows once any site fired in the process
        # (another test file's faults): start both registries clean.
        ref_fp.reset_hits()
        fp.reset_hits()
    want = _call(method, ref.url + path, body)
    got = _call(method, port.url + path, body)
    assert got[0] == want[0], (route, got[2], want[2])
    assert got[1].split(";")[0] == want[1].split(";")[0]
    if path == "/admin/drain":          # leave both fronts serving
        for srv in (ref, port):
            assert _call("POST", srv.url + "/admin/undrain", {})[0] == 200
    if method == "HEAD":
        assert got[2] == want[2] == b""
    elif path == "/metrics":
        assert _types(got[2].decode()) == _types(want[2].decode())
    elif "json" in want[1]:
        assert _shape(json.loads(got[2])) == _shape(json.loads(want[2]))
    else:
        assert got[2] == want[2]


@pytest.mark.parametrize("path,body,raw", [
    ("/api/embed", None, b"{not json"),
    ("/api/embed", {"input": 3}, None),
    ("/api/embed", {"input": ["a", 3]}, None),
    ("/api/embeddings", {"prompt": ["a"]}, None),
    ("/api/embeddings", None, b"{not json"),
])
def test_embed_errors_answer_as_the_reference(fronts, path, body, raw):
    ref, port = fronts
    want = _call("POST", ref.url + path, body, raw)
    got = _call("POST", port.url + path, body, raw)
    assert got[0] == want[0] == 400
    assert json.loads(got[2]) == json.loads(want[2])


def _shed_total(url: str) -> float:
    text = _call("GET", url + "/metrics")[2].decode()
    return float(next(line.split()[1] for line in text.splitlines()
                      if line.startswith("serve_requests_shed_total ")))


def test_drain_sheds_embeds_without_counting_them(fronts):
    ref, port = fronts
    for srv in (ref, port):
        _call("POST", srv.url + "/admin/drain", {})
    try:
        before = {srv.url: _shed_total(srv.url) for srv in (ref, port)}
        for path, body in (("/api/embed", {"input": "a"}),
                           ("/api/embeddings", {"prompt": "a"})):
            want = _call("POST", ref.url + path, body)
            got = _call("POST", port.url + path, body)
            assert got[0] == want[0] == 503
            assert got[3].get("Retry-After") == want[3].get("Retry-After")
            assert json.loads(got[2]) == json.loads(want[2])
        for srv in (ref, port):
            assert _shed_total(srv.url) == before[srv.url]
        # A generate during the drain is shed AND counted, on both.
        gen = ROUTES[("POST", "/api/generate")]
        assert _call("POST", port.url + "/api/generate", gen)[0] == 503
        assert _shed_total(port.url) == before[port.url] + 1
    finally:
        for srv in (ref, port):
            _call("POST", srv.url + "/admin/undrain", {})


def test_engine_metrics_are_a_superset_of_the_reference():
    cfg = ref_config("tiny")
    params = ref_llama.init_params_quantized(cfg, jax.random.PRNGKey(0),
                                             dtype=jnp.float32)
    ref_engine = TPUEngine(params, cfg, RefByteTokenizer(cfg.vocab_size),
                           num_slots=2, max_seq=128, kv_mode="paged",
                           page_size=16, kv_quant=True)
    engine = TorchEngine(
        params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        get_config("tiny"), ByteTokenizer(cfg.vocab_size), num_slots=2,
        max_seq=128, page_size=16, kv_quant=True, device="cpu")
    servers = []
    try:
        names = []
        for eng, make in ((ref_engine, RefServer), (engine, OllamaServer)):
            eng.warmup((16,))
            srv = make(eng, addr="127.0.0.1:0").start()
            servers.append(srv)
            deadline = time.monotonic() + 120
            while not eng.ready() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert eng.ready()
            assert _call("POST", srv.url + "/api/generate",
                         ROUTES[("POST", "/api/generate")])[0] == 200
            text = _call("GET", srv.url + "/metrics")[2].decode()
            names.append({line.split()[0] for line in text.splitlines()
                          if line.strip() and not line.startswith("#")})
        missing = {n for n in names[0] - names[1]
                   if not n.startswith(SPEC_TIER_PREFIXES)}
        assert missing == set()
        assert {"decode_device_ms", "loop_stall_ms", "loop_stall_last_ms",
                "serve_flight_dumps_total", "retry_attempts_total",
                'serve_replica_class{class="mixed"}',
                "serve_trace_spans_total"} <= names[1]
    finally:
        for srv in servers:
            srv.stop()
        ref_engine.stop()
        engine.stop()


def test_spec_series_equal_the_references():
    """With speculation on, /metrics of both fronts carry the same
    ``serve_spec_*`` names and labels (per-source and aggregate series,
    the tree series)."""
    cfg = ref_config("tiny")
    params = ref_llama.init_params_quantized(cfg, jax.random.PRNGKey(0),
                                             dtype=jnp.float32)
    ref_engine = TPUEngine(params, cfg, RefByteTokenizer(cfg.vocab_size),
                           num_slots=2, max_seq=128, kv_mode="paged",
                           page_size=16, kv_quant=True, spec_k=4,
                           spec_tree_nodes=8)
    engine = TorchEngine(
        params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        get_config("tiny"), ByteTokenizer(cfg.vocab_size), num_slots=2,
        max_seq=128, page_size=16, kv_quant=True, spec_k=4,
        spec_tree_nodes=8, device="cpu")
    servers = []
    try:
        names = []
        for eng, make in ((ref_engine, RefServer), (engine, OllamaServer)):
            srv = make(eng, addr="127.0.0.1:0").start()
            servers.append(srv)
            assert _call("POST", srv.url + "/api/generate",
                         ROUTES[("POST", "/api/generate")])[0] == 200
            text = _call("GET", srv.url + "/metrics")[2].decode()
            names.append({line.split()[0] for line in text.splitlines()
                          if line.startswith("serve_spec_")})
        assert names[0] == names[1]
        assert {'serve_spec_accept_rate{source="ngram"}',
                "serve_spec_tree_accepted_path_len"} <= names[1]
    finally:
        for srv in servers:
            srv.stop()
        ref_engine.stop()
        engine.stop()
