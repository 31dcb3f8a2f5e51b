"""Backend interface for the port's serving stack, plus the FakeLLM test
double — a copy of p2p_llm_chat_tpu/serve/backend.py (the port imports
nothing of the reference package).

Streaming-first: a backend accepts a :class:`GenerateRequest` and returns
an iterator of text deltas; the HTTP front (api.py) collects them or
forwards them as NDJSON chunks. ``normalize_request`` is the shared Ollama
admission contract (context ids, num_ctx clamp, num_predict <= 0).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Iterator, Optional, Protocol, runtime_checkable


class OverloadError(RuntimeError):
    """Admission queue at capacity: the request is shed at submit time
    (fast-fail) instead of burning the queue deadline in line. The HTTP
    front maps it to ``503`` with a ``Retry-After`` header — well-formed
    backpressure a client can act on, in milliseconds rather than
    ``queue_timeout_s``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass
class GenerateOptions:
    """Sampling options (subset of Ollama's ``options`` object)."""

    max_tokens: int = 256           # Ollama: num_predict
    temperature: float = 0.0        # 0 => greedy
    top_p: float = 1.0
    top_k: int = 0                  # 0 => disabled
    # Ollama repeat_penalty: logits of tokens in the recent window are
    # divided (positive) / multiplied (negative) by this. 1.0 = off (our
    # default — deterministic parity with the samplers' oracles; Ollama's
    # own default is 1.1, which clients send explicitly to get it). The
    # window is the last 64 tokens (Ollama's repeat_last_n default).
    repeat_penalty: float = 1.0
    num_ctx: int = 0                # per-request context cap (0 = server max)
    seed: Optional[int] = None
    stop: tuple[str, ...] = ()

    @classmethod
    def from_ollama(cls, options: Optional[dict]) -> "GenerateOptions":
        o = options or {}
        stop = o.get("stop") or ()
        if isinstance(stop, str):
            stop = (stop,)
        return cls(
            max_tokens=int(o.get("num_predict", 256)),
            temperature=float(o.get("temperature", 0.0)),
            top_p=float(o.get("top_p", 1.0)),
            top_k=int(o.get("top_k", 0)),
            repeat_penalty=float(o.get("repeat_penalty", 1.0)),
            num_ctx=int(o.get("num_ctx", 0)),
            seed=o.get("seed"),
            stop=tuple(stop),
        )


@dataclass
class GenerateRequest:
    prompt: str
    model: str = ""
    options: GenerateOptions = field(default_factory=GenerateOptions)
    # Ollama /api/generate "context": token ids of a prior exchange,
    # prepended to this prompt (the final response record returns the
    # updated ids). Tuple of ints; empty = fresh conversation.
    context: tuple = ()
    # grafttrace (obs/trace.py): the propagated or minted trace id; the
    # scheduler records its queue-wait, prefill and decode spans only
    # when ``trace_sampled`` is set.
    trace_id: str = ""
    trace_sampled: bool = False
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    arrival_time: float = field(default_factory=time.monotonic)


@dataclass
class RequestStats:
    """Per-request timing — the north-star metric is p50 TTFT (BASELINE.md),
    so timing is in-tree from day one (SURVEY.md §5 tracing)."""

    ttft_s: Optional[float] = None        # arrival -> first token
    total_s: Optional[float] = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    # Ollama "context" for /api/generate responses: the full token ids
    # (context + prompt + completion) a follow-up request can send back.
    # None = backend doesn't track ids (FakeLLM).
    context: Optional[list] = None


@runtime_checkable
class Backend(Protocol):
    name: str

    def generate_stream(self, req: GenerateRequest,
                        stats: Optional[RequestStats] = None) -> Iterator[str]:
        """Yield text deltas for the completion; return when done."""
        ...

    def models(self) -> list[str]:
        """Model tags served (for /api/tags)."""
        ...


def collect(backend: Backend, req: GenerateRequest,
            stats: Optional[RequestStats] = None) -> str:
    return "".join(backend.generate_stream(req, stats))


def normalize_request(tokenizer, vocab_size: int, max_seq: int,
                      req: GenerateRequest,
                      min_bucket: int = 16) -> tuple[list, int, int]:
    """Shared admission normalization for every serving engine — the
    Ollama request contract in one place so the single-host scheduler and
    the multihost lockstep front cannot drift (they once did: num_predict
    <= 0 and the num_ctx floor diverged between the two copies).

    - ``context`` ids are untrusted client input: out-of-vocab raises
      ValueError (callers map it to a per-request failure, never batch
      corruption). They prepend verbatim — they already carry their own
      BOS — and the new prompt follows without a second BOS.
    - Ollama ``num_ctx`` caps this request's context below the server
      max; truncation keeps the prompt TAIL (recent context wins, the
      same direction Ollama truncates).
    - Ollama ``num_predict <= 0`` means "until EOS / context full", not
      "almost nothing".

    Returns (ids, max_new, ctx_limit).
    """
    ctx = [int(t) for t in req.context]
    if ctx and not all(0 <= t < vocab_size for t in ctx):
        raise ValueError("context contains token ids outside the model's "
                         f"vocabulary (size {vocab_size})")
    ids = ctx + tokenizer.encode(req.prompt, add_bos=not ctx)
    ctx_limit = max_seq
    opts = req.options
    if opts.num_ctx > 0:
        ctx_limit = max(min_bucket, min(ctx_limit, opts.num_ctx))
    max_prompt = ctx_limit - 2
    if len(ids) > max_prompt:
        ids = ids[-max_prompt:]
    budget = ctx_limit - 1 - len(ids)
    want = opts.max_tokens if opts.max_tokens > 0 else budget
    return ids, max(1, min(want, budget)), ctx_limit


class FakeLLM:
    """Canned-response backend.

    Deterministic: replies echo the tail of the prompt so tests can assert
    content flowed through. Configurable per-token delay lets chat-path tests
    exercise streaming/timeout behavior. This mirrors the role Ollama
    unavailability plays in the reference — the UI must degrade gracefully
    either way (web/streamlit_app.py:99-101).
    """

    def __init__(self, name: str = "fake-llm", token_delay_s: float = 0.0,
                 reply_template: str = "Thanks for your message! You said: {tail}") -> None:
        self.name = name
        self.token_delay_s = token_delay_s
        self.reply_template = reply_template
        self._lock = threading.Lock()
        self.requests_served = 0

    def _reply_for(self, req: GenerateRequest) -> str:
        # The UI wraps the peer's message in a fixed template ending in
        # "Reply:" (web/streamlit_app.py:93), and chat prompts end with an
        # "assistant:" marker — skip trailing instruction/role lines (anything
        # ending in ':') and echo the last content line.
        lines = [ln.strip() for ln in req.prompt.splitlines() if ln.strip()]
        body = [ln for ln in lines if not ln.endswith(":")]
        tail = body[-1] if body else ""
        return self.reply_template.format(tail=tail)

    def generate_stream(self, req: GenerateRequest,
                        stats: Optional[RequestStats] = None) -> Iterator[str]:
        with self._lock:
            self.requests_served += 1
        text = self._reply_for(req)
        words = text.split(" ")
        words = words[: max(1, req.options.max_tokens)]
        if stats is not None:
            stats.prompt_tokens = len(req.prompt.split())
            # Fake context round trip: carry forward the request's ids
            # plus one marker per prompt word (contract-shape only).
            stats.context = list(req.context) + list(
                range(stats.prompt_tokens))
        first = True
        emitted = ""
        for i, w in enumerate(words):
            if self.token_delay_s:
                time.sleep(self.token_delay_s)
            delta = w if i == 0 else " " + w
            if stats is not None:
                if first:
                    stats.ttft_s = time.monotonic() - req.arrival_time
                    first = False
                stats.completion_tokens += 1
            emitted += delta
            for s in req.options.stop:
                if s and s in emitted:
                    yield delta[: len(delta) - (len(emitted) - emitted.index(s))]
                    if stats is not None:
                        stats.total_s = time.monotonic() - req.arrival_time
                    return
            yield delta
        if stats is not None:
            stats.total_s = time.monotonic() - req.arrival_time

    def models(self) -> list[str]:
        return [self.name]

    def embed(self, texts: list[str]) -> tuple[list[list[float]], int]:
        """Deterministic unit vectors from a content hash — the /api/embed
        contract without a model, mirroring FakeLLM's role for /api/generate.
        Equal texts embed equal; different texts (almost surely) differ."""
        import hashlib
        import math

        out = []
        for t in texts:
            h = hashlib.sha256(t.encode()).digest()
            raw = [(b - 127.5) / 127.5 for b in (h * 2)]     # 64 dims
            norm = math.sqrt(sum(x * x for x in raw)) or 1.0
            out.append([x / norm for x in raw])
        return out, sum(len(t.split()) for t in texts)
