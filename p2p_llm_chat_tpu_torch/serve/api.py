"""Ollama-compatible HTTP front for the port: the reference's
``OllamaServer`` (p2p_llm_chat_tpu/serve/api.py), for one engine or for
several behind one front (serve/multi.py): generate, chat (the resolved
engine's chat template), show and the embed routes resolve the backend
by the request's ``model`` tag (an unknown tag serves the default),
``/api/tags`` and ``/api/ps`` list every tag, ``/readyz`` waits for
every engine, and the session routes answer 501 on a multi front, as in
the reference.

Routes: ``POST /api/generate``, ``POST /api/chat``, ``POST /api/embed``
and the legacy ``POST /api/embeddings``, ``GET /api/tags``, ``POST
/api/show``, ``GET /api/ps``, ``GET /api/version``, ``GET /`` and ``HEAD
/``; 501 for the model-management routes (``POST /api/pull|push|create|
copy``, ``DELETE /api/delete``); ``GET /healthz``, ``GET /readyz``, ``GET
/metrics``; ``POST /admin/drain`` / ``/admin/undrain``; ``GET
/admin/trace`` and ``POST /admin/trace/dump``; the shared prefix tier
(``GET /admin/prefix``, ``GET /admin/prefix/export``, ``POST
/admin/prefix/import``), session migration (``GET /admin/session``,
``GET /admin/session/export``, ``POST /admin/session/import``, ``/forget``
and ``/park_all``) and disaggregated prefill (``POST
/admin/disagg/prefill``), each with the reference's status codes (501
when the backend has no prefix store or KV tier). Generate and chat read
the conversation's ``session`` from the body or ``X-Session-Id``. The
replica's class (``SERVE_REPLICA_CLASS``, serve/disagg.py) shows on
``/readyz`` and as ``serve_replica_class``.

The robustness plane is the reference's: ``FAIL_POINTS`` is parsed at
construction (a malformed spec fails at boot), the ``serve.api.parse``
and ``serve.api.stream`` sites, ``failpoint_hits_total{site}`` and
``retry_attempts_total`` on ``/metrics``, and the ``X-Graft-Trace``
header parsed or minted per request, with an ``api.request`` span in the
front's bounded span store (obs/trace.py), which the engine's scheduler
shares.

The JSON wire format is the reference's, key for key (``json.dumps`` with
its default separators): non-streaming responses carry ``response`` /
``message`` plus Ollama's timing fields and, for /api/generate, the
updated ``context`` ids; streaming (the default when ``stream`` is
omitted) sends NDJSON ``{"model", "created_at", <key>, "done": false}``
chunks and a final ``done: true`` record.

``SERVE_BACKEND=torch`` selects the port's engine
(serve/engine.build_engine_from_env); ``fake`` (the default) selects
FakeLLM. ``SERVE_ROUTER_UPSTREAMS`` makes ``main`` start the replica
router (serve/router.py) instead of a front.
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from datetime import datetime, timezone
from typing import Iterator, Optional

from ..obs import trace as _trace
from ..utils import backoff as _backoff
from ..utils import failpoints as _failpoints
from ..utils.env import env_or
from ..utils.failpoints import failpoint
from ..utils.http import HttpServer, Request, Response, Router
from ..utils.log import get_logger
from ..utils.metrics import Registry
from .backend import (Backend, GenerateOptions, GenerateRequest,
                      OverloadError, RequestStats)
from .disagg import REPLICA_CLASSES, replica_class_from_env
from .engine import default_chat_prompt

log = get_logger("serve.torch_api")


def now_rfc3339() -> str:
    """RFC3339/ISO-8601 UTC timestamp, the format Go's time.Time marshals to."""
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


def render_chat_prompt(messages: list[dict], backend: Backend) -> str:
    fn = getattr(backend, "render_chat", None)
    if fn is not None:
        return fn(messages)
    return default_chat_prompt(messages)


class OllamaServer:
    def __init__(self, backend: Backend, addr: Optional[str] = None,
                 registry: Optional[Registry] = None,
                 replica_class: Optional[str] = None) -> None:
        self.backend = backend
        # prefill | decode | mixed (serve/disagg.py), from the env unless
        # given.
        self.replica_class = (replica_class if replica_class is not None
                              else replica_class_from_env())
        if self.replica_class not in REPLICA_CLASSES:
            raise ValueError(f"replica_class must be one of "
                             f"{REPLICA_CLASSES}, got "
                             f"{self.replica_class!r}")
        # Eager FAIL_POINTS parse: a malformed spec fails here, at boot.
        _failpoints.load_env()
        self.addr_cfg = (addr if addr is not None
                         else env_or("SERVE_ADDR", "127.0.0.1:11434"))
        self.metrics = registry or Registry()
        self._m_requests = self.metrics.counter("serve_requests_total")
        self._m_errors = self.metrics.counter("serve_errors_total")
        self._m_shed = self.metrics.counter("serve_requests_shed_total")
        self._m_tokens = self.metrics.counter("serve_completion_tokens_total")
        self._m_inflight = self.metrics.gauge("serve_inflight_requests")
        self._m_ttft = self.metrics.histogram("serve_ttft_seconds")
        self._m_total = self.metrics.histogram("serve_request_seconds")
        self.router = Router()
        self.router.add("POST", "/api/generate", self._generate)
        self.router.add("POST", "/api/chat", self._chat)
        self.router.add("GET", "/api/tags", self._tags)
        self.router.add("POST", "/api/show", self._show)
        self.router.add("GET", "/api/ps", self._ps)
        self.router.add("POST", "/api/embed", self._embed)
        self.router.add("POST", "/api/embeddings", self._embeddings_legacy)
        # Ollama's model-management routes answer an explicit 501: models
        # are provisioned at startup.
        for ep in ("/api/pull", "/api/push", "/api/create", "/api/copy"):
            self.router.add("POST", ep, self._unsupported)
        self.router.add("DELETE", "/api/delete", self._unsupported)
        self.router.add("GET", "/api/version", lambda r: Response(200, {
            "version": "0.1.0-p2p-llm-chat-tpu"}))
        self.router.add("GET", "/", lambda r: Response(
            200, "Ollama is running", content_type="text/plain"))
        self.router.add("HEAD", "/", lambda r: Response(200, ""))
        self.router.add("GET", "/metrics", self._metrics)
        self.router.add("GET", "/healthz",
                        lambda r: Response(200, {"status": "ok"}))
        self.router.add("GET", "/readyz", self._readyz)
        # Drain hooks (the reference router's retire path): draining
        # finishes in-flight streams, refuses new work with 503 and flips
        # /readyz. The front-level flag covers backends without their own
        # drain() (FakeLLM); the engine's scheduler drains too, so direct
        # submits shed as well.
        self._draining = threading.Event()
        self.router.add("POST", "/admin/drain", self._drain)
        self.router.add("POST", "/admin/undrain", self._undrain)
        # The shared prefix tier and session migration: control JSON
        # through a router, KV bytes replica to replica (the import's pull
        # form); disaggregated prefill parks a new conversation's prompt
        # as a session a decode replica pulls.
        self.router.add("GET", "/admin/prefix", self._prefix_list)
        self.router.add("GET", "/admin/prefix/export", self._prefix_export)
        self.router.add("POST", "/admin/prefix/import", self._prefix_import)
        self.router.add("GET", "/admin/session", self._session_list)
        self.router.add("GET", "/admin/session/export", self._session_export)
        self.router.add("POST", "/admin/session/import", self._session_import)
        self.router.add("POST", "/admin/session/forget", self._session_forget)
        self.router.add("POST", "/admin/session/park_all",
                        self._session_park_all)
        self.router.add("POST", "/admin/disagg/prefill",
                        self._disagg_prefill)
        # The bounded span store; bind_registry registers the
        # serve_trace_* series, and the backend's scheduler records its
        # spans into the same store.
        self.trace = _trace.TraceStore()
        self.trace.bind_registry(self.metrics)
        set_store = getattr(backend, "set_trace_store", None)
        if callable(set_store):
            set_store(self.trace)
        self.router.add("GET", "/admin/trace", self._trace_list)
        self.router.add("POST", "/admin/trace/dump", self._trace_dump)
        self._server: Optional[HttpServer] = None

    # -- helpers -------------------------------------------------------------

    def _readyz(self, req: Request) -> Response:
        cls = self.replica_class
        if self._draining.is_set():
            return Response(503, {"status": "draining", "class": cls},
                            headers={"Retry-After": "5"})
        fn = getattr(self.backend, "ready", None)
        try:
            ok = bool(fn()) if callable(fn) else True
        except Exception:   # noqa: BLE001 — a broken probe is "not ready"
            log.exception("readiness probe failed")
            ok = False
        if ok:
            return Response(200, {"status": "ready", "class": cls})
        return Response(503, {"status": "warming", "class": cls},
                        headers={"Retry-After": "2"})

    def _drain(self, req: Request) -> Response:
        """POST /admin/drain: refuse new work (503 + Retry-After, /readyz
        "draining"); in-flight streams finish."""
        self._draining.set()
        fn = getattr(self.backend, "drain", None)
        if callable(fn):
            fn()
        log.info("draining: new requests refused, in-flight streams "
                 "finishing")
        return Response(200, {"status": "draining"})

    def _undrain(self, req: Request) -> Response:
        self._draining.clear()
        fn = getattr(self.backend, "undrain", None)
        if callable(fn):
            fn()
        log.info("undrained: accepting new requests")
        return Response(200, {"status": "ready"})

    def _shed_if_draining(self, count: bool = True) -> Optional[Response]:
        """The drain shed of every work-accepting route. ``count=False``
        (the embed routes, which never move serve_requests_total) keeps
        serve_requests_shed_total <= serve_requests_total."""
        if not self._draining.is_set():
            return None
        if count:
            self._m_shed.inc()
        return Response(503, {"error": "server is draining; retry "
                                       "elsewhere"},
                        headers={"Retry-After": "5"})

    def _resolve(self, model: str):
        """The backend of a request's model tag: a multi-model front
        (serve/multi.py) routes by tag; a single backend serves every
        name."""
        fn = getattr(self.backend, "for_model", None)
        return fn(model) if fn is not None else self.backend

    def _metrics(self, req: Request) -> Response:
        text = self.metrics.render()
        snap = getattr(self.backend, "metrics_snapshot", None)
        if snap is not None:
            lines = []
            typed: set = set()
            for name, v in sorted(snap().items()):
                base = name.split("{", 1)[0]
                if base not in typed:
                    typed.add(base)
                    kind = ("counter" if base.endswith("_total") else "gauge")
                    lines.append(f"# TYPE {base} {kind}\n")
                lines.append(f"{name} {v}\n")
            text += "".join(lines)
            # The process's kernel launches by wrapper (ops.wrappers), so
            # a client reads which kernels its traffic ran: 0 on the
            # CPU, whose tensors take the plain versions.
            from ..ops import wrappers
            text += "# TYPE kernel_launches_total counter\n" + "".join(
                f'kernel_launches_total{{kernel="{k}"}} {w.launches}\n'
                for k, w in sorted(wrappers().items()))
        # Robustness plane (process-wide): per-site failpoint hits (no
        # series at all while nothing fired) and the shared retry
        # counter; then the replica class as a constant 1-gauge.
        fp = _failpoints.snapshot()
        if fp:
            text += "# TYPE failpoint_hits_total counter\n" + "".join(
                f'failpoint_hits_total{{site="{site}"}} {n}\n'
                for site, n in sorted(fp.items()))
        text += ("# TYPE retry_attempts_total counter\n"
                 f"retry_attempts_total {_backoff.retries_total()}\n")
        text += ("# TYPE serve_replica_class gauge\n"
                 f'serve_replica_class{{class="{self.replica_class}"}} 1\n')
        return Response(200, text, content_type="text/plain; version=0.0.4")

    def _finalize_record(self, model: str, stats: RequestStats,
                         started: float) -> dict:
        total_ns = int((time.monotonic() - started) * 1e9)
        eval_ns = int((stats.total_s or 0) * 1e9)
        ttft_ns = int((stats.ttft_s or 0) * 1e9)
        return {
            "model": model,
            "created_at": now_rfc3339(),
            "done": True,
            "done_reason": "stop",
            "total_duration": total_ns,
            "load_duration": 0,
            "prompt_eval_count": stats.prompt_tokens,
            "prompt_eval_duration": ttft_ns,
            "eval_count": stats.completion_tokens,
            "eval_duration": max(0, eval_ns - ttft_ns),
        }

    def _observe(self, stats: RequestStats) -> None:
        if stats.ttft_s is not None:
            self._m_ttft.observe(stats.ttft_s)
        if stats.total_s is not None:
            self._m_total.observe(stats.total_s)
        self._m_tokens.inc(stats.completion_tokens)

    def _run(self, req_body: dict, prompt: str, key: str, wrap,
             with_context: bool = False,
             headers: Optional[dict] = None) -> Response:
        """Shared generate/chat execution (the reference's ``_run``).
        ``headers``: the request's, for ``X-Graft-Trace``."""
        # Failpoint: the parse/validate site. ``error`` answers a
        # well-formed 500 record; ``raise`` takes the router's handler
        # envelope (also a 500).
        act = failpoint("serve.api.parse")
        if act is not None and act.kind == "error":
            self._m_errors.inc()
            return Response(500, {"error": act.msg
                                  or "injected fault: serve.api.parse"})
        model = str(req_body.get("model") or self.backend.name)
        opts = GenerateOptions.from_ollama(req_body.get("options"))
        stream = req_body.get("stream")
        stream = True if stream is None else bool(stream)
        context: tuple = ()
        if with_context:
            raw_ctx = req_body.get("context") or ()
            if not (isinstance(raw_ctx, (list, tuple))
                    and all(type(t) is int and 0 <= t < 2 ** 31
                            for t in raw_ctx)):
                return Response(400, {"error": "context must be a list of "
                                               "non-negative token ids"})
            context = tuple(raw_ctx)
        session = str(req_body.get("session") or "")
        if not session and headers is not None:
            session = str(headers.get("x-session-id") or "")
        # Adopt the propagated trace context, or mint one here (this
        # front is then the trace's origin).
        tctx = _trace.parse_header((headers or {}).get(_trace.HEADER_LC))
        if tctx is None:
            tctx = _trace.mint()
        greq = GenerateRequest(prompt=prompt, model=model, options=opts,
                               context=context, session=session,
                               trace_id=tctx.trace_id,
                               trace_sampled=tctx.sampled)
        stats = RequestStats()
        self._m_requests.inc()
        self._m_inflight.add(1)
        started = time.monotonic()
        # Drain shed after the request counters move, as the scheduler's
        # OverloadError path below does (shed <= requests on /metrics).
        shed = self._shed_if_draining()
        if shed is not None:
            self._m_inflight.add(-1)
            return shed
        try:
            deltas = self._resolve(model).generate_stream(greq, stats)
        except OverloadError as e:
            self._m_inflight.add(-1)
            self._m_shed.inc()
            return Response(
                503, {"error": str(e)},
                headers={"Retry-After": str(max(1, round(e.retry_after_s)))})
        except Exception as e:  # noqa: BLE001
            self._m_errors.inc()
            self._m_inflight.add(-1)
            log.exception("submit failed")
            return Response(500, {"error": str(e)})

        if not stream:
            try:
                text = "".join(deltas)
            except Exception as e:  # noqa: BLE001
                self._m_errors.inc()
                self._m_inflight.add(-1)
                log.exception("generate failed")
                return Response(500, {"error": str(e)})
            self._m_inflight.add(-1)
            self._observe(stats)
            if tctx.sampled:
                self.trace.add(tctx.trace_id, "api.request", started,
                               time.monotonic() - started, endpoint=key,
                               tokens=stats.completion_tokens)
            rec = self._finalize_record(model, stats, started)
            rec[key] = wrap(text)
            if with_context and stats.context is not None:
                rec["context"] = stats.context
            return Response(200, rec)

        def ndjson() -> Iterator[bytes]:
            try:
                for delta in deltas:
                    # Failpoint: the per-delta yield. ``drop`` discards
                    # this chunk (the stream still ends cleanly);
                    # ``raise`` takes the error record below.
                    act = failpoint("serve.api.stream")
                    if act is not None and act.kind == "drop":
                        continue
                    chunk = {"model": model, "created_at": now_rfc3339(),
                             key: wrap(delta), "done": False}
                    yield (json.dumps(chunk) + "\n").encode()
                rec = self._finalize_record(model, stats, started)
                rec[key] = wrap("")
                if with_context and stats.context is not None:
                    rec["context"] = stats.context
                yield (json.dumps(rec) + "\n").encode()
                self._observe(stats)
            except Exception as e:  # noqa: BLE001
                self._m_errors.inc()
                log.exception("stream generate failed")
                yield (json.dumps({"error": str(e), "done": True})
                       + "\n").encode()
            finally:
                self._m_inflight.add(-1)
                # The span ends with the stream (error paths included).
                if tctx.sampled:
                    self.trace.add(tctx.trace_id, "api.request", started,
                                   time.monotonic() - started,
                                   endpoint=key,
                                   tokens=stats.completion_tokens)

        return Response(200, stream=ndjson(),
                        content_type="application/x-ndjson")

    # -- handlers ------------------------------------------------------------

    def _generate(self, req: Request) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        prompt = str(body.get("prompt") or "")
        return self._run(body, prompt, "response", lambda t: t,
                         with_context=True, headers=req.headers)

    def _chat(self, req: Request) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        messages = body.get("messages") or []
        if not isinstance(messages, list):
            return Response(400, {"error": "messages must be a list"})
        resolved = self._resolve(str(body.get("model")
                                     or self.backend.name))
        prompt = render_chat_prompt(messages, resolved)
        return self._run(body, prompt, "message",
                         lambda t: {"role": "assistant", "content": t},
                         headers=req.headers)

    def _tags(self, req: Request) -> Response:
        return Response(200, {"models": [
            {"name": m, "model": m, "modified_at": now_rfc3339(),
             "size": 0, "digest": "", "details": {"family": "p2p-llm-chat-tpu"}}
            for m in self.backend.models()
        ]})

    def _show(self, req: Request) -> Response:
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        name = str(body.get("model") or body.get("name") or "")
        if (name and name not in self.backend.models()
                and not hasattr(self.backend, "for_model")):
            # A single-model front keeps the strict 404; a multi-model
            # front answers for the default tag, as generate and chat do.
            return Response(404, {"error": f"model {name!r} not found"})
        cfg = getattr(self._resolve(name or self.backend.name), "config",
                      None)
        details = {"family": "p2p-llm-chat-tpu", "format": "torch",
                   "parameter_size": "", "quantization_level": ""}
        info = {}
        if cfg is not None:
            info = {"general.architecture": "llama" if cfg.num_experts == 0
                    else "mixtral",
                    "llama.context_length": cfg.max_seq_len,
                    "llama.embedding_length": cfg.hidden_size,
                    "llama.block_count": cfg.num_layers,
                    "llama.attention.head_count": cfg.num_heads,
                    "llama.attention.head_count_kv": cfg.num_kv_heads,
                    "llama.vocab_size": cfg.vocab_size}
        return Response(200, {"modelfile": "", "parameters": "",
                              "template": "", "details": details,
                              "model_info": info})

    def _embed(self, req: Request) -> Response:
        """Ollama ``POST /api/embed``: ``input`` is one string or a list
        (``prompt`` tolerated); answers ``{"embeddings": [[...], ...]}``
        with timing and token-count fields. Backed by the engine's
        ``embed`` (TorchEngine: models' ``embed_pooled``) or FakeLLM's hash
        vectors."""
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        shed = self._shed_if_draining(count=False)
        if shed is not None:
            return shed
        model = str(body.get("model") or self.backend.name)
        fn = getattr(self._resolve(model), "embed", None)
        if fn is None:
            return Response(400, {"error": "this model does not support "
                                           "embeddings"})
        inp = body.get("input")
        if inp is None:
            inp = body.get("prompt")
        if inp is not None and not isinstance(inp, (str, list)):
            return Response(400, {"error": "input must be a string or list "
                                           "of strings"})
        texts = [inp] if isinstance(inp, str) else list(inp or [])
        if not all(isinstance(t, str) for t in texts):
            return Response(400, {"error": "input must be a string or list "
                                           "of strings"})
        started = time.monotonic()
        try:
            vecs, n_tokens = fn(texts)
        except Exception as e:  # noqa: BLE001
            self._m_errors.inc()
            log.exception("embed failed")
            return Response(500, {"error": str(e)})
        return Response(200, {
            "model": model,
            "embeddings": vecs,
            "total_duration": int((time.monotonic() - started) * 1e9),
            "load_duration": 0,
            "prompt_eval_count": n_tokens,
        })

    def _embeddings_legacy(self, req: Request) -> Response:
        """Ollama's legacy ``POST /api/embeddings`` (``{"prompt"}`` ->
        ``{"embedding": [...]}``)."""
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        shed = self._shed_if_draining(count=False)
        if shed is not None:
            return shed
        fn = getattr(self._resolve(str(body.get("model")
                                       or self.backend.name)),
                     "embed", None)
        if fn is None:
            return Response(400, {"error": "this model does not support "
                                           "embeddings"})
        prompt = body.get("prompt")
        if not isinstance(prompt, str):
            return Response(400, {"error": "prompt must be a string"})
        try:
            vecs, _ = fn([prompt])
        except Exception as e:  # noqa: BLE001
            self._m_errors.inc()
            log.exception("embed failed")
            return Response(500, {"error": str(e)})
        return Response(200, {"embedding": vecs[0]})

    # -- the shared prefix tier (serve/prefix.py) ----------------------------

    def _pull(self, req: Request, src: str, path: str, query: dict,
              extra: dict) -> bytes:
        """GET ``src`` + ``path`` from a peer replica (an import's pull
        form), forwarding the caller's trace header; raises on failure."""
        import urllib.parse
        import urllib.request
        hdrs = dict(extra)
        raw_tid = req.headers.get(_trace.HEADER_LC)
        if raw_tid:
            hdrs[_trace.HEADER] = raw_tid
        url = (f"{src.rstrip('/')}{path}?"
               f"{urllib.parse.urlencode(query)}")
        with urllib.request.urlopen(urllib.request.Request(
                url, headers=hdrs), timeout=30.0) as r:
            return r.read()

    def _prefix_list(self, req: Request) -> Response:
        """``GET /admin/prefix``: {token_hash: {len, hits}} of the cached
        prefixes; 501 without a prefix store (FakeLLM, prefix cache
        off)."""
        fn = getattr(self.backend, "prefix_hashes", None)
        got = fn() if fn is not None else None
        if got is None:
            return Response(501, {"error": "no prefix store"})
        return Response(200, {"prefixes": got})

    def _prefix_export(self, req: Request) -> Response:
        """``GET /admin/prefix/export?h=<token_hash>``: one entry's wire
        payload for a peer replica."""
        fn = getattr(self.backend, "prefix_export", None)
        if fn is None:
            return Response(501, {"error": "no prefix store"})
        h = str(req.query.get("h") or "")
        if not h:
            return Response(400, {"error": "missing h=<token_hash>"})
        data = fn(h)
        if data is None:
            return Response(404, {"error": f"prefix {h} not cached"})
        return Response(200, data, content_type="application/octet-stream")

    def _prefix_import(self, req: Request) -> Response:
        """``POST /admin/prefix/import``: install a peer's entry. The body
        is the raw payload, or JSON ``{"from": <peer url>, "h": <hash>}``
        (the pull form: the bytes move replica to replica)."""
        fn = getattr(self.backend, "prefix_import", None)
        if fn is None:
            return Response(501, {"error": "no prefix store"})
        data = req.body or b""
        if data[:1] == b"{":
            try:
                spec = req.json() or {}
            except ValueError:
                return Response(400, {"error": "invalid json"})
            src = str(spec.get("from") or "")
            h = str(spec.get("h") or "")
            if not src or not h:
                return Response(400, {"error": "need from + h"})
            sid = req.headers.get("x-session-id")
            try:
                data = self._pull(req, src, "/admin/prefix/export",
                                  {"h": h},
                                  {"X-Session-Id": sid} if sid else {})
            except Exception as e:   # noqa: BLE001 — peer may be gone
                return Response(502, {"error": f"pull from {src} "
                                               f"failed: {e}"})
        entry = fn(data)
        if entry is None:
            return Response(400, {"error": "malformed or incompatible "
                                           "prefix payload"})
        return Response(200, {"status": "ok", "len": entry.length,
                              "hash": entry.token_hash})

    # -- session migration (serve/kv_tier.py) ---------------------------------

    def _session_backend(self):
        """The backend when it has a KV tier, else None (no tier, or a
        multi-model front: every /admin/session route then answers
        501)."""
        fn = getattr(self.backend, "session_list", None)
        if fn is None or fn() is None:
            return None
        return self.backend

    def _session_list(self, req: Request) -> Response:
        """``GET /admin/session``: {key: {len, nbytes, parked, idle_s}}."""
        be = self._session_backend()
        if be is None:
            return Response(501, {"error": "no session tier"})
        return Response(200, {"sessions": be.session_list() or {}})

    def _session_export(self, req: Request) -> Response:
        """``GET /admin/session/export?key=<key>``: the parked payload (a
        resident session parks first). The session is retained until the
        destination's ack (forget)."""
        be = self._session_backend()
        if be is None:
            return Response(501, {"error": "no session tier"})
        key = str(req.query.get("key") or "")
        if not key:
            return Response(400, {"error": "missing key=<session key>"})
        data = be.session_export(key)
        if data is None:
            return Response(404, {"error": f"session {key!r} not open"})
        return Response(200, data, content_type="application/octet-stream")

    def _session_import(self, req: Request) -> Response:
        """``POST /admin/session/import``: install a peer's session. The
        body is the raw payload, or the pull form ``{"from": <peer url>,
        "key": <key>}``. A traced import records ``disagg.import``."""
        be = self._session_backend()
        if be is None:
            return Response(501, {"error": "no session tier"})
        tctx = _trace.parse_header(req.headers.get(_trace.HEADER_LC))
        t_imp = time.monotonic()
        data = req.body or b""
        if data[:1] == b"{":
            try:
                spec = req.json() or {}
            except ValueError:
                return Response(400, {"error": "invalid json"})
            src = str(spec.get("from") or "")
            key = str(spec.get("key") or "")
            if not src or not key:
                return Response(400, {"error": "need from + key"})
            try:
                data = self._pull(req, src, "/admin/session/export",
                                  {"key": key}, {"X-Session-Id": key})
            except Exception as e:   # noqa: BLE001 — peer may be gone
                return Response(502, {"error": f"pull from {src} "
                                               f"failed: {e}"})
        sess = be.session_import(data)
        if sess is None:
            return Response(400, {"error": "malformed or incompatible "
                                           "session payload"})
        if tctx is not None and tctx.sampled:
            self.trace.add(tctx.trace_id, "disagg.import", t_imp,
                           time.monotonic() - t_imp,
                           key=sess.key, tokens=sess.length)
        return Response(200, {"status": "ok", "key": sess.key,
                              "len": sess.length})

    def _session_forget(self, req: Request) -> Response:
        """``POST /admin/session/forget {"key"}``: the migration ack (drop
        the parked source copy; not an eviction)."""
        be = self._session_backend()
        if be is None:
            return Response(501, {"error": "no session tier"})
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        key = str(body.get("key") or "")
        if not key:
            return Response(400, {"error": "missing key"})
        if not be.session_forget(key):
            return Response(404, {"error": f"session {key!r} not parked "
                                           "here"})
        return Response(200, {"status": "forgotten", "key": key})

    def _session_park_all(self, req: Request) -> Response:
        """``POST /admin/session/park_all``: park every resident session
        (the drain-as-migration first step)."""
        be = self._session_backend()
        if be is None:
            return Response(501, {"error": "no session tier"})
        be.session_park_all()
        return Response(200, {"status": "parked",
                              "sessions": be.session_list() or {}})

    # -- disaggregated prefill (serve/disagg.py) ------------------------------

    def _disagg_prefill(self, req: Request) -> Response:
        """``POST /admin/disagg/prefill {"path", "body"}``: prefill the
        wrapped generate or chat request (its prompt rendered exactly as
        that route would) minus its last token and retain it as a session
        a decode replica pulls. 200 ``{"status": "parked", "key", "len",
        "parked"}``; 422 when this request cannot ride the handoff; 501
        without the surface or a KV tier; 503 when draining or shedding."""
        fn = getattr(self.backend, "prefill_park", None)
        if fn is None:
            return Response(501, {"error": "no disagg prefill surface"})
        shed = self._shed_if_draining(count=False)
        if shed is not None:
            return shed
        try:
            outer = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        if not isinstance(outer, dict):
            return Response(400, {"error": "request body must be an "
                                           "object"})
        path = str(outer.get("path") or "/api/generate")
        body = outer.get("body")
        if not isinstance(body, dict):
            return Response(400, {"error": "need a body object"})
        model = str(body.get("model") or self.backend.name)
        context: tuple = ()
        if path == "/api/chat":
            messages = body.get("messages") or []
            if not isinstance(messages, list):
                return Response(400, {"error": "messages must be a list"})
            prompt = render_chat_prompt(messages, self._resolve(model))
        else:
            prompt = str(body.get("prompt") or "")
            raw_ctx = body.get("context") or ()
            if not (isinstance(raw_ctx, (list, tuple))
                    and all(type(t) is int and 0 <= t < 2 ** 31
                            for t in raw_ctx)):
                return Response(400, {"error": "context must be a list "
                                               "of non-negative token "
                                               "ids"})
            context = tuple(raw_ctx)
        session = str(body.get("session") or "")
        if not session:
            session = str(req.headers.get("x-session-id") or "")
        # Traced only when the caller forwarded the request's header (an
        # internal hop never mints).
        tctx = _trace.parse_header(req.headers.get(_trace.HEADER_LC))
        greq = GenerateRequest(
            prompt=prompt, model=model,
            options=GenerateOptions.from_ollama(body.get("options")),
            context=context, session=session,
            trace_id=tctx.trace_id if tctx else "",
            trace_sampled=bool(tctx and tctx.sampled))
        t_park = time.monotonic()
        sl = getattr(self.backend, "session_list", None)
        if sl is None or sl() is None:
            return Response(501, {"error": "no disagg prefill surface"})
        try:
            meta = fn(greq)
        except OverloadError as e:
            return Response(
                503, {"error": str(e)},
                headers={"Retry-After": str(max(1,
                                                round(e.retry_after_s)))})
        except Exception as e:  # noqa: BLE001 — a failed prefill is a 500
            self._m_errors.inc()
            log.exception("disagg prefill failed")
            return Response(500, {"error": str(e)})
        if meta is None:
            return Response(422, {"error": "request cannot ride the "
                                           "handoff (unindexable or "
                                           "prefill not retained)"})
        if tctx is not None and tctx.sampled:
            self.trace.add(tctx.trace_id, "disagg.prefill_park", t_park,
                           time.monotonic() - t_park,
                           key=str(meta.get("key") or ""),
                           tokens=int(meta.get("len") or 0))
        return Response(200, {"status": "parked", **meta})

    def _trace_list(self, req: Request) -> Response:
        """``GET /admin/trace``: the trace ids held and the store's stats;
        ``?id=<trace id>`` answers that trace's spans (wall-anchored
        ``t0_ms``, mergeable with other replicas')."""
        tid = str(req.query.get("id") or "")
        if tid:
            spans = self.trace.get(tid)
            if not spans:
                return Response(404, {"error": f"trace {tid!r} not held "
                                               "(evicted or never "
                                               "sampled here)"})
            return Response(200, {"id": tid, "spans": spans})
        return Response(200, {"traces": self.trace.ids(),
                              "stats": self.trace.stats()})

    def _trace_dump(self, req: Request) -> Response:
        """``POST /admin/trace/dump``: write the scheduler's flight
        recorder to its JSON file and answer the path (501 without one:
        FakeLLM)."""
        fn = getattr(self.backend, "flight_dump", None)
        if fn is None:
            return Response(501, {"error": "no flight recorder (backend "
                                           "has no scheduler loop)"})
        try:
            path = fn("on_demand")
        except OSError as e:
            return Response(500, {"error": f"flight dump failed: {e}"})
        return Response(200, {"status": "dumped", "path": path})

    def _unsupported(self, req: Request) -> Response:
        return Response(501, {
            "error": "model management is not supported: models are "
                     "provisioned at startup (CKPT_DIR, SERVE_MODELS or "
                     "MODEL_CONFIG; see README)"})

    def _ps(self, req: Request) -> Response:
        """Ollama ``GET /api/ps``: the loaded models (all resident)."""
        return Response(200, {"models": [
            {"name": m, "model": m, "size": 0, "digest": "",
             "expires_at": "", "size_vram": 0}
            for m in self.backend.models()
        ]})

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "OllamaServer":
        self._server = HttpServer(self.router, self.addr_cfg).start()
        # Tag this replica's spans with its bound address.
        self.trace.replica = self._server.addr
        log.info("serve API (%s backend) on %s", self.backend.name,
                 self._server.addr)
        return self

    @property
    def url(self) -> str:
        assert self._server is not None
        return self._server.url

    def serve_forever(self) -> None:
        self.start()
        threading.Event().wait()

    def stop(self) -> None:
        if self._server:
            self._server.stop()


def main() -> None:
    """Entry point: ``SERVE_BACKEND=torch`` serves the port's engine (on
    the card unless ``SERVE_DEVICE=cpu``); ``fake`` serves FakeLLM.

    ``SERVE_ROUTER_UPSTREAMS`` (checked before any backend is built)
    starts the replica router instead (serve/router.py: this process
    only routes, builds no engine and never touches the card; replicas
    it spawns are the port's entry). It and ``SERVE_COORDINATOR`` are
    alternatives: configuring both is a boot error rather than a silent
    pick. SIGTERM stops the router, and any replica its autoscaler
    spawned, with exit 0.

    Under ``SERVE_COORDINATOR`` (serve/multihost.py), and on the ranks of
    ``SERVE_TP`` (serve/tp.py; one engine, or several under
    ``SERVE_MODELS``, serve/multi.py), a follower runs no front: it mirrors the
    leader's rounds or ops until the leader broadcasts shutdown. The
    leader serves the front until SIGTERM, then stops the plane (the
    shutdown broadcast), and exits 0 once its followers have; every rank
    logs its summary line and leaves the world on the way out."""
    if env_or("SERVE_ROUTER_UPSTREAMS", ""):
        if env_or("SERVE_COORDINATOR", ""):
            raise SystemExit(
                "SERVE_ROUTER_UPSTREAMS and SERVE_COORDINATOR are "
                "mutually exclusive modes (replica-router vs lockstep "
                "SPMD); set exactly one")
        from .router import build_router_from_env
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
        router = build_router_from_env()
        try:
            router.serve_forever()
        finally:
            router.stop()
        return
    from .backend import FakeLLM
    kind = env_or("SERVE_BACKEND", "fake")
    if kind == "fake":
        backend: Backend = FakeLLM()
    elif kind == "torch":
        from .engine import build_engine_from_env
        backend = build_engine_from_env()
    else:
        raise SystemExit(f"SERVE_BACKEND must be fake|torch for the "
                         f"PyTorch front, got {kind!r}")
    if not getattr(backend, "lockstep", hasattr(backend, "follower_loop")):
        OllamaServer(backend).serve_forever()
        return
    if backend.is_follower:
        try:
            backend.follower_loop()
        finally:
            backend.close()
        return
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    server = OllamaServer(backend)
    try:
        server.serve_forever()
    finally:
        server.stop()
        backend.stop()
        backend.close()


if __name__ == "__main__":
    main()
