"""Chat web UI with the AI reply co-pilot.

The port's copy of ``p2p_llm_chat_tpu/ui.py``: the same wire bytes and
behaviour, so port and reference peers mix in one fleet; the port imports
nothing of the reference package.

Reference: web/streamlit_app.py — a Streamlit page per user that (a) sends
messages through its node's ``POST /send``, (b) polls ``GET /inbox`` every
2 s, (c) renders messenger-style bubbles sorted by timestamp, and (d) runs
the co-pilot loop: per incoming message, a "Suggest a reply" button calls
the LLM with a fixed template and an accept button posts the suggestion
back through /send (streamlit_app.py:161-190).

Streamlit is not in this image, so the equivalent here is self-contained:
a single-page HTML/JS app served by this tiny process. Behavior parity:

- config via the same env vars: ``NODE_HTTP``, ``OLLAMA_URL``, ``LLM_MODEL``
  (streamlit_app.py:26-28) + additive ``UI_ADDR``.
- 2 s inbox poll with ``after=""`` — full-history refetch, the quirk that
  makes history survive page reloads (SURVEY.md §2).
- sent messages live only in browser memory (the reference keeps them only
  in st.session_state — no persistence, streamlit_app.py:34-37).
- the LLM prompt template is byte-identical to streamlit_app.py:93, the
  60 s timeout matches :95, and failures degrade to the same placeholder
  strings "(LLM error)" / "(LLM unavailable: ...)" (:99-101).

The UI server proxies ``/node/*`` to the node and ``/api/suggest`` to the
LLM so the browser needs no CORS setup.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from importlib import resources
from typing import Optional

from .utils.env import env_float, env_int, env_or
from .utils.http import HttpServer, Request, Response, Router, http_json
from .utils.log import get_logger

log = get_logger("ui")

# Byte-identical to web/streamlit_app.py:93 — part of the observable LLM
# contract the new serving stack must reproduce.
SUGGEST_TEMPLATE = (
    "You are a helpful assistant. Draft a concise, friendly reply to the "
    "following message:\n\n{msg}\n\nReply:"
)
LLM_TIMEOUT_S = 60.0   # streamlit_app.py:95 (reference default;
#                        UI_LLM_TIMEOUT_S overrides per deployment)


class ChatUI:
    def __init__(self, node_http: Optional[str] = None,
                 ollama_url: Optional[str] = None,
                 llm_model: Optional[str] = None,
                 addr: Optional[str] = None) -> None:
        self.node_http = (node_http if node_http is not None
                          else env_or("NODE_HTTP", "http://127.0.0.1:8081")).rstrip("/")
        self.ollama_url = (ollama_url if ollama_url is not None
                           else env_or("OLLAMA_URL", "http://127.0.0.1:11434")).rstrip("/")
        self.llm_model = llm_model if llm_model is not None else env_or("LLM_MODEL", "llama3.1")
        self.addr_cfg = addr if addr is not None else env_or("UI_ADDR", "127.0.0.1:8501")
        # Suggestion length bound. The reference sends NO num_predict
        # (server default applies) and 0 preserves that; operators and
        # the loadgen CPU profile cap it — an unbounded co-pilot reply
        # is the single biggest per-request cost on small hosts.
        self.suggest_predict = env_int("UI_SUGGEST_PREDICT", 0)
        # Upstream LLM deadline. 60 s is the reference's (streamlit_app
        # :95); slow dev-profile hosts raise it so a suggestion that is
        # slow-but-within-SLO completes instead of becoming an error.
        self.llm_timeout_s = env_float("UI_LLM_TIMEOUT_S", LLM_TIMEOUT_S)
        self.router = Router()
        self.router.add("GET", "/", self._index)
        self.router.add("GET", "/config.json", lambda r: Response(200, {
            "node_http": self.node_http, "llm_model": self.llm_model}))
        self.router.add("POST", "/api/suggest", self._suggest)
        self.router.add("POST", "/api/suggest/stream", self._suggest_stream)
        self.router.add("GET", "/node/me", self._proxy_node_get("/me"))
        self.router.add("GET", "/node/inbox", self._proxy_node_get("/inbox"))
        self.router.add("POST", "/node/send", self._proxy_node_post("/send"))
        self.router.add("GET", "/healthz", lambda r: Response(200, {"status": "ok"}))
        self._server: Optional[HttpServer] = None

    # -- handlers ------------------------------------------------------------

    def _index(self, req: Request) -> Response:
        html = (resources.files("p2p_llm_chat_tpu_torch") / "web_static" / "index.html").read_text()
        return Response(200, html, content_type="text/html; charset=utf-8")

    @staticmethod
    def _fwd_headers(req: Request) -> dict:
        """Wire context to carry across a proxy hop: a browser that
        arrived with X-Graft-Trace / X-Session-Id keeps them on the
        upstream leg (the UI never mints either — an untraced browser
        stays untraced)."""
        out = {}
        tid = req.headers.get("x-graft-trace")
        if tid:
            out["X-Graft-Trace"] = tid
        sid = req.headers.get("x-session-id")
        if sid:
            out["X-Session-Id"] = sid
        return out

    def _suggest(self, req: Request) -> Response:
        """ai_suggest (streamlit_app.py:89-101): call the LLM with the fixed
        template; degrade to placeholder strings on any failure."""
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        content = str(body.get("content") or "")
        payload = {
            "model": self.llm_model,
            "prompt": SUGGEST_TEMPLATE.format(msg=content),
            "stream": False,
        }
        if self.suggest_predict > 0:
            payload["options"] = {"num_predict": self.suggest_predict}
        try:
            status, resp = http_json(
                "POST", f"{self.ollama_url}/api/generate", payload,
                timeout=self.llm_timeout_s, raise_for_status=False,
                headers=self._fwd_headers(req))
            if status == 200 and isinstance(resp, dict) and "response" in resp:
                suggestion = str(resp["response"]).strip()   # :97-98
            else:
                suggestion = "(LLM error)"                   # :99
        except Exception as e:  # noqa: BLE001
            suggestion = f"(LLM unavailable: {e})"           # :100-101
        return Response(200, {"suggestion": suggestion})

    def _suggest_stream(self, req: Request) -> Response:
        """Streaming co-pilot suggestions: the serve stack already
        streams NDJSON (serve/api.py); this forwards its deltas to the
        browser as ``{"delta", "done"}`` lines so suggestion text appears
        incrementally instead of after the full generation. The
        non-streaming ``/api/suggest`` keeps the reference's buffered
        contract (streamlit_app.py:89-101) for stream:false clients."""
        import urllib.error
        import urllib.request

        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"error": "invalid json"})
        content = str(body.get("content") or "")

        # Open the upstream BEFORE committing to a 200 NDJSON stream —
        # the serve front's own discipline ("never a mid-NDJSON error
        # record after a 200 already went out"). In particular a shed
        # (503 + Retry-After, the overload contract) forwards verbatim
        # with its Retry-After, so the browser/loadgen sees well-formed
        # backpressure instead of a buried mid-stream error line.
        payload = {
            "model": self.llm_model,
            "prompt": SUGGEST_TEMPLATE.format(msg=content),
            "stream": True,
        }
        if self.suggest_predict > 0:
            payload["options"] = {"num_predict": self.suggest_predict}
        data = json.dumps(payload).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        # grafttrace (obs/trace.py): a co-pilot request that arrives
        # with an X-Graft-Trace header keeps its id on the serve leg,
        # so the merged timeline covers browser -> UI -> serve. The UI
        # never mints — an untraced browser stays untraced, and the
        # serve front mints its own for ingress accounting.
        tid = req.headers.get("x-graft-trace")
        if tid:
            headers["X-Graft-Trace"] = tid
        # Session affinity rides the hop too: the serve front's router
        # pins X-Session-Id requests to the replica holding their KV.
        sid = req.headers.get("x-session-id")
        if sid:
            headers["X-Session-Id"] = sid
        r = urllib.request.Request(
            f"{self.ollama_url}/api/generate", data=data,
            headers=headers,
            method="POST")
        try:
            resp = urllib.request.urlopen(r, timeout=self.llm_timeout_s)
        except urllib.error.HTTPError as e:
            detail = e.read()[:300].decode("utf-8", "replace")
            headers = {}
            retry = e.headers.get("Retry-After")
            if retry:
                headers["Retry-After"] = retry
            e.close()
            return Response(e.code, {"error": detail or "LLM error"},
                            headers=headers)
        except Exception as e:  # noqa: BLE001 — same degradation
            # strings as the buffered path (streamlit_app.py:100-101);
            # error:true lets the browser treat the text as a failure
            # marker instead of appending it to a partial suggestion.
            # graftcheck: stream-ok single constant yield, no upstream or gauge held
            def unavailable(msg=str(e)):
                yield (json.dumps({
                    "delta": f"(LLM unavailable: {msg})", "done": True,
                    "error": True,
                }) + "\n").encode("utf-8")
            return Response(200, stream=unavailable(),
                            content_type="application/x-ndjson")

        def gen():
            # The finally (not the `with` alone) is what settles things
            # on CLIENT disconnect: HttpServer close()es this generator,
            # GeneratorExit lands at the current yield — which sits
            # OUTSIDE the `with resp:` on the error path — and the
            # upstream serve connection (still holding a decode slot)
            # must be released now, not at GC.
            try:
                with resp:
                    for line in resp:
                        try:
                            obj = json.loads(line)
                        except ValueError:
                            continue
                        done = bool(obj.get("done"))
                        yield (json.dumps({
                            "delta": str(obj.get("response", "")),
                            "done": done,
                        }) + "\n").encode("utf-8")
                        if done:
                            return
                yield (json.dumps({"delta": "", "done": True})
                       + "\n").encode("utf-8")
            except Exception as e:  # noqa: BLE001 — mid-stream failure
                # after deltas already went out: the error record keeps
                # the browser from treating a half suggestion as whole.
                yield (json.dumps({
                    "delta": f"(LLM unavailable: {e})", "done": True,
                    "error": True,
                }) + "\n").encode("utf-8")
            finally:
                try:
                    resp.close()
                except Exception:   # noqa: BLE001 — teardown only
                    pass

        return Response(200, stream=gen(),
                        content_type="application/x-ndjson")

    def _proxy_node_get(self, path: str):
        def handler(req: Request) -> Response:
            q = f"?{urllib.parse.urlencode(req.query)}" if req.query else ""
            try:
                status, body = http_json("GET", f"{self.node_http}{path}{q}",
                                         timeout=5.0, raise_for_status=False,
                                         headers=self._fwd_headers(req))
            except ConnectionError as e:
                return Response(502, {"error": str(e)})
            return Response(status, body)
        return handler

    def _proxy_node_post(self, path: str):
        def handler(req: Request) -> Response:
            try:
                payload = req.json()
            except ValueError:
                return Response(400, {"error": "invalid json"})
            try:
                status, body = http_json("POST", f"{self.node_http}{path}", payload,
                                         timeout=10.0, raise_for_status=False,
                                         headers=self._fwd_headers(req))
            except ConnectionError as e:
                return Response(502, {"error": str(e)})
            return Response(status, body)
        return handler

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ChatUI":
        self._server = HttpServer(self.router, self.addr_cfg).start()
        log.info("chat UI on http://%s (node=%s, llm=%s)",
                 self._server.addr, self.node_http, self.ollama_url)
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
    ChatUI().serve_forever()


if __name__ == "__main__":
    main()
