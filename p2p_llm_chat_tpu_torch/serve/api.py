"""Ollama-compatible HTTP front for the port, trimmed to this slice.

The reference's ``OllamaServer`` (p2p_llm_chat_tpu/serve/api.py) cut down
to ``POST /api/generate``, ``POST /api/chat``, ``GET /api/tags``,
``POST /api/show``, ``GET /healthz``, ``GET /readyz`` and ``GET /metrics``.
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

from ..utils.env import env_or
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
        self.router.add("GET", "/metrics", self._metrics)
        self.router.add("GET", "/healthz",
                        lambda r: Response(200, {"status": "ok"}))
        self.router.add("GET", "/readyz", self._readyz)
        self._server: Optional[HttpServer] = None

    # -- helpers -------------------------------------------------------------

    def _readyz(self, req: Request) -> Response:
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
             with_context: bool = False) -> Response:
        """Shared generate/chat execution (the reference's ``_run``)."""
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
        greq = GenerateRequest(prompt=prompt, model=model, options=opts,
                               context=context)
        stats = RequestStats()
        self._m_requests.inc()
        self._m_inflight.add(1)
        started = time.monotonic()
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
            rec = self._finalize_record(model, stats, started)
            rec[key] = wrap(text)
            if with_context and stats.context is not None:
                rec["context"] = stats.context
            return Response(200, rec)

        def ndjson() -> Iterator[bytes]:
            try:
                for delta in deltas:
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
                         with_context=True)

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
                         lambda t: {"role": "assistant", "content": t})

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
            info = {"general.architecture": "llama",
                    "llama.context_length": cfg.max_seq_len,
                    "llama.embedding_length": cfg.hidden_size,
                    "llama.block_count": cfg.num_layers,
                    "llama.attention.head_count": cfg.num_heads,
                    "llama.attention.head_count_kv": cfg.num_kv_heads,
                    "llama.vocab_size": cfg.vocab_size}
        return Response(200, {"modelfile": "", "parameters": "",
                              "template": "", "details": details,
                              "model_info": info})

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "OllamaServer":
        self._server = HttpServer(self.router, self.addr_cfg).start()
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
