"""Multi-model serving: several resident backends behind one Ollama front
— the port of p2p_llm_chat_tpu/serve/multi.py.

Each tag maps to its own fully independent backend (own scheduler, own
KV pool, own decode loop: requests for different models never share a
batch), and the front resolves the backend per request through
:meth:`MultiBackend.for_model`. An unknown tag serves the DEFAULT model
instead of 404ing, as in the reference: a client that names whatever
``LLM_MODEL`` says must still be answered.

Configured through ``SERVE_MODELS`` (serve/engine.py): ``tag=ref,...``,
a ref being a config name or a checkpoint directory.

The port warms the engines one after another on one background thread
(:meth:`MultiBackend.warmup`), where the reference warms them at once:
on one card a CUDA-graph capture of one engine must not overlap another
engine's launches, which the per-device capture lock
(serve/scheduler.capture_lock_for) guards as well.

Under ``SERVE_TP`` every tag's engine serves on the same ranks, one op
stream for the plane (serve/tp.py), and the multi-model front is
lockstep as one engine is (serve/api.main): rank 0 serves the front, and
on every other rank :meth:`MultiBackend.follower_loop` runs each op on
the engine it names, which also mirrors the leader's warmups.
:meth:`MultiBackend.close` logs one summary line per tag and one line of
launches, leaves the world once and reaps the followers once.
"""

from __future__ import annotations

import json
import threading
from typing import Iterator, Optional

from ..utils.log import get_logger
from .backend import Backend, GenerateRequest, RequestStats

log = get_logger("serve.multi")


class MultiBackend:
    """Route requests across named backends; the Backend protocol plus a
    ``for_model`` resolver the API front uses for chat templates, embeds
    and /api/show."""

    def __init__(self, backends: dict[str, Backend],
                 default: Optional[str] = None) -> None:
        if not backends:
            raise ValueError("need at least one backend")
        self.backends = dict(backends)
        self.default = default if default is not None else next(iter(backends))
        if self.default not in self.backends:
            raise ValueError(f"default {self.default!r} not among "
                             f"{sorted(self.backends)}")
        self.name = self.default
        self._warmup_error: Optional[BaseException] = None
        # The SERVE_PROFILE_PORT listener over every engine's loop
        # (obs/profile_server.py), closed by stop().
        self.profile_server = None
        # Under tp: the follower processes this rank started (a local tp
        # world), reaped by close().
        self.followers: list = []

    # -- tensor parallelism: one plane for every tag (serve/tp.py) --------

    @property
    def lockstep(self) -> bool:
        """Ranks in step: the engines serve over a tp plane."""
        return any(getattr(b, "lockstep", False)
                   for b in self.backends.values())

    @property
    def is_follower(self) -> bool:
        return any(getattr(b, "is_follower", False)
                   for b in self.backends.values())

    def follower_loop(self) -> None:
        """Mirror the leader's ops, each on the engine its header names
        (the tag's position in the spec)."""
        if not self.is_follower:
            raise RuntimeError("the leader does not follow")
        from .tp import tp_follower_loop
        tp_follower_loop({i: b.scheduler
                          for i, b in enumerate(self.backends.values())})

    def close(self) -> None:
        """Log this rank's summary line per tag (digest, digests equal,
        decode step and collective p50, peak GB) and one line of the
        kernels' launches, then leave the world and reap the followers,
        once: after :meth:`stop` on the leader, after
        :meth:`follower_loop` returns on a follower."""
        from ..ops import wrappers
        from .engine import leave_plane
        if not self.lockstep:
            return
        rank = 0
        for tag, b in self.backends.items():
            summary = dict(b.tp_summary(), model=tag)
            rank = summary["rank"]
            log.info("tp rank %d model %s summary: %s", rank, tag,
                     json.dumps(summary))
        log.info("tp rank %d launches: %s", rank, json.dumps(
            {k: w.launches for k, w in wrappers().items()}))
        self.followers = leave_plane(self.followers)

    def for_model(self, model: str) -> Backend:
        """Exact tag match, else the default (drop-in fallback)."""
        return self.backends.get(model, self.backends[self.default])

    def generate_stream(self, req: GenerateRequest,
                        stats: Optional[RequestStats] = None) -> Iterator[str]:
        return self.for_model(req.model).generate_stream(req, stats)

    def models(self) -> list[str]:
        return list(self.backends)

    def metrics_snapshot(self) -> dict[str, float]:
        """Per-model series with a ``model`` label (the /metrics renderer
        groups TYPE lines by base name)."""
        out: dict[str, float] = {}
        for tag, b in self.backends.items():
            snap = getattr(b, "metrics_snapshot", None)
            if snap is None:
                continue
            # Prometheus label-value escaping (backslash, quote, newline):
            # an unescaped tag would break the whole page for scrapers.
            esc = (tag.replace("\\", "\\\\").replace('"', '\\"')
                   .replace("\n", "\\n"))
            for k, v in snap().items():
                if k.endswith("}"):
                    # An already-labelled series: merge the model label
                    # into its brace block (a second {...} is malformed).
                    out[f'{k[:-1]},model="{esc}"}}'] = v
                else:
                    out[f'{k}{{model="{esc}"}}'] = v
        return out

    def ready(self) -> bool:
        """/readyz gating: ready only when EVERY engine is (a half-warmed
        front would serve some tags cold). Backends without a probe
        count as ready."""
        for b in self.backends.values():
            fn = getattr(b, "ready", None)
            if callable(fn) and not fn():
                return False
        return True

    @property
    def warmup_error(self) -> Optional[BaseException]:
        """The first engine warmup's error (the front then stays unready
        for good), else None."""
        if self._warmup_error is not None:
            return self._warmup_error
        for b in self.backends.values():
            err = getattr(b, "warmup_error", None)
            if err is not None:
                return err
        return None

    def warmup(self, buckets: tuple[int, ...] = (128, 256)) -> None:
        """Warm every engine, one after another, on one background thread.
        Every engine reports not-ready from here until its own warmup is
        done; a failed warmup stops the walk (the rest stay unready and
        :attr:`warmup_error` says why). A follower rank warms through the
        leader's ops."""
        if self.is_follower:
            return
        engines = [b for b in self.backends.values()
                   if getattr(b, "warmup", None) is not None]
        for b in engines:
            pending = getattr(b, "note_warmup_pending", None)
            if pending is not None:
                pending()

        def run() -> None:
            for b in engines:
                try:
                    b.warmup(buckets, background=False)
                except Exception as e:   # noqa: BLE001 — kept, front unready
                    log.exception("warmup of %s failed", b.name)
                    self._warmup_error = e
                    return

        threading.Thread(target=run, daemon=True,
                         name="multi-warmup").start()

    def set_trace_store(self, store) -> None:
        """Every engine records its spans into the front's store."""
        for b in self.backends.values():
            fn = getattr(b, "set_trace_store", None)
            if fn is not None:
                fn(store)

    def drain(self) -> None:
        """Draining the front drains EVERY engine (the replica retires as
        a unit, not per tag)."""
        for b in self.backends.values():
            fn = getattr(b, "drain", None)
            if fn is not None:
                fn()

    def undrain(self) -> None:
        for b in self.backends.values():
            fn = getattr(b, "undrain", None)
            if fn is not None:
                fn()

    def stop(self) -> None:
        if self.profile_server is not None:
            self.profile_server.stop()
            self.profile_server = None
        for b in self.backends.values():
            fn = getattr(b, "stop", None)
            if fn is not None:
                fn()
