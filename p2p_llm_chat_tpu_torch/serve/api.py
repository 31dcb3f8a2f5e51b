"""Ollama-compatible HTTP front for the port: the reference's
``OllamaServer`` (p2p_llm_chat_tpu/serve/api.py) for a single-model
replica.

Routes: ``POST /api/generate``, ``POST /api/chat``, ``POST /api/embed``
and the legacy ``POST /api/embeddings``, ``GET /api/tags``, ``POST
/api/show``, ``GET /api/ps``, ``GET /api/version``, ``GET /`` and ``HEAD
/``; 501 for the model-management routes (``POST /api/pull|push|create|
copy``, ``DELETE /api/delete``); ``GET /healthz``, ``GET /readyz``, ``GET
/metrics``; ``POST /admin/drain`` / ``/admin/undrain``; ``GET
/admin/trace`` and ``POST /admin/trace/dump``. The reference's prefix,
session and disaggregated-prefill admin routes belong to features the
port does not serve yet.

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
FakeLLM.
"""

from __future__ import annotations

import json
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
from .engine import default_chat_prompt

log = get_logger("serve.torch_api")

# This replica takes any work (the reference's default replica class).
REPLICA_CLASS = "mixed"


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
                 registry: Optional[Registry] = None) -> None:
        self.backend = backend
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
        if self._draining.is_set():
            return Response(503, {"status": "draining", "class": REPLICA_CLASS},
                            headers={"Retry-After": "5"})
        fn = getattr(self.backend, "ready", None)
        try:
            ok = bool(fn()) if callable(fn) else True
        except Exception:   # noqa: BLE001 — a broken probe is "not ready"
            log.exception("readiness probe failed")
            ok = False
        if ok:
            return Response(200, {"status": "ready", "class": REPLICA_CLASS})
        return Response(503, {"status": "warming", "class": REPLICA_CLASS},
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
                 f'serve_replica_class{{class="{REPLICA_CLASS}"}} 1\n')
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
        # Adopt the propagated trace context, or mint one here (this
        # front is then the trace's origin).
        tctx = _trace.parse_header((headers or {}).get(_trace.HEADER_LC))
        if tctx is None:
            tctx = _trace.mint()
        greq = GenerateRequest(prompt=prompt, model=model, options=opts,
                               context=context, trace_id=tctx.trace_id,
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
            deltas = self.backend.generate_stream(greq, stats)
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
        prompt = render_chat_prompt(messages, self.backend)
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
        if name and name not in self.backend.models():
            return Response(404, {"error": f"model {name!r} not found"})
        cfg = getattr(self.backend, "config", None)
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
        fn = getattr(self.backend, "embed", None)
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
        fn = getattr(self.backend, "embed", None)
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
                     "provisioned at startup (MODEL_CONFIG; see README)"})

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
    the card unless ``SERVE_DEVICE=cpu``); ``fake`` serves FakeLLM."""
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
    OllamaServer(backend).serve_forever()


if __name__ == "__main__":
    main()
