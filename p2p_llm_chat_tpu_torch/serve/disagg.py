"""Disaggregated prefill/decode serving (Splitwise / DistServe-style) — the
port's copy of p2p_llm_chat_tpu/serve/disagg.py (the port imports nothing
of the reference package).

Replicas declare a **class** (``SERVE_REPLICA_CLASS=prefill|decode|
mixed``) advertised on ``/readyz`` and as ``serve_replica_class`` on
``/metrics``; the router (serve/router.py) keeps per-class pools and
sends a **new conversation to the prefill pool**, where the replica
prefills the prompt minus its last token and retains it as a session
(``scheduler.prefill_park``, kernel D on the card); the least-loaded
**decode** replica then pulls the session over ``/admin/session/import``
(export -> adopt -> ack -> affinity flip) and the original request
streams from there — its first token sampled by the verify-shaped wake
(kernel B's verify mode on the card), so the output is byte-identical to
a never-disaggregated run.

Why the handoff is exact: the prefill replica retains exactly
``ids[:-1]`` (a one-token throwaway generation, because the tier keeps
"prompt + all generated but the last"), so >= 1 suffix token remains for
the destination's wake to forward; its logits seed the request's first
sample from the request's own seeded RNG, as a cold admission would.
Park payloads are the raw pool words, so the logits match to the bit.

Failure contract (failpoint ``serve.disagg.handoff`` pins it): any
failed handoff step degrades to finishing the request on the prefill
replica — which wakes the just-parked copy locally, or cold-admits —
never a client-visible error. The ledger moves
``disagg_handoff_failures_total``; ``kv_sessions_lost_total`` does not
(the source retained the session: the ack discipline).

This module owns the class vocabulary, the handoff choreography
(HTTP-level, called by the router off its lock), and the per-class
autoscaler; the prefill-side park lives in ``scheduler.prefill_park``,
the wire format in ``serve/kv_tier.py``, and pool routing in
``serve/router.py``. Flags: ``SERVE_REPLICA_CLASS`` (this replica's
role), ``SERVE_PREFILL_REPLICAS`` / ``SERVE_DECODE_REPLICAS`` (the
fleet shape that arms the per-class autoscaler), with the
``SERVE_ROUTER_AUTOSCALE_*`` knobs applying per class. Torch-free, like
the router.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Optional

from ..utils.env import env_float, env_int, env_or
from ..utils.failpoints import failpoint
from ..utils.log import get_logger

log = get_logger("serve.disagg")

REPLICA_CLASSES = ("prefill", "decode", "mixed")


def replica_class_from_env() -> str:
    """This replica's declared role. ``mixed`` (the default) is the
    compatibility class: it takes any work, so an undisaggregated fleet
    behaves as a classless one."""
    cls = env_or("SERVE_REPLICA_CLASS", "mixed").strip().lower()
    if cls not in REPLICA_CLASSES:
        raise SystemExit(
            f"SERVE_REPLICA_CLASS must be one of {REPLICA_CLASSES}, "
            f"got {cls!r}")
    return cls


class HandoffError(RuntimeError):
    """A handoff step failed — the caller degrades to the prefill
    replica (the session, if parked, is retained there)."""


class HandoffUnsupported(Exception):
    """The prefill replica can never hand off (no KV tier / no
    prefill_park surface, a 501): remember and stop asking."""


def drive_handoff(prefill_url: str, decode_url: str, path: str,
                  body: dict, session: str = "",
                  timeout_s: float = 300.0,
                  trace: str = "") -> Optional[dict]:
    """One prefill→decode handoff, HTTP choreography only (no router
    state — the caller owns pools, affinity and metrics; this runs OFF
    the router's lock because every step is network I/O):

    1. ``POST {prefill}/admin/disagg/prefill`` with the original
       request — the replica chunk-prefills ``ids[:-1]`` and retains
       the session (``{"key", "len"}`` back; KV bytes stay put).
    2. ``POST {decode}/admin/session/import {"from", "key"}`` — the
       decode replica PULLS the payload straight from the prefill
       replica (the export parks the resident session first); the
       router moves only control JSON.
    3. ``POST {prefill}/admin/session/forget`` — the ack; best-effort
       (a failed forget leaves a redundant parked copy cost-eviction
       ages out).

    Returns the prefill meta dict (``key`` included) on success; None
    when the replica answered a structured "can't" for THIS request
    (prompt too short to index, draining 503 — fall back quietly, not
    a failure); raises :class:`HandoffUnsupported` on a 501 (never ask
    this replica again) and :class:`HandoffError` on a real mid-flight
    failure (count it, degrade to the prefill replica)."""
    failpoint("serve.disagg.handoff")
    headers = {"Content-Type": "application/json"}
    if session:
        headers["X-Session-Id"] = session
    # grafttrace: ``trace`` is the original request's X-Graft-Trace
    # value — forwarded on the prefill dispatch and the decode-side
    # import so both replicas' spans (disagg.prefill_park,
    # disagg.import, and the scheduler's wake) share the request's id.
    if trace:
        headers["X-Graft-Trace"] = trace
    req = urllib.request.Request(
        f"{prefill_url}/admin/disagg/prefill",
        data=json.dumps({"path": path, "body": body}).encode(),
        headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            meta = json.loads(r.read())
    except urllib.error.HTTPError as e:
        code = e.code
        e.close()
        if code == 501:
            raise HandoffUnsupported(prefill_url)
        if code in (422, 503):
            # 422: this request is not parkable (too short to index,
            # tier raced) — prefill it wherever routing lands it.
            # 503: the prefill replica is shedding/draining — the
            # normal retry ladder owns that, not the failure ledger.
            return None
        raise HandoffError(f"prefill step answered HTTP {code}")
    except Exception as e:  # noqa: BLE001 — network-level failure
        raise HandoffError(f"prefill step failed: {e}") from e
    key = str(meta.get("key") or "")
    if not key:
        raise HandoffError("prefill step returned no session key")
    imp_headers = {"Content-Type": "application/json"}
    if trace:
        imp_headers["X-Graft-Trace"] = trace
    imp = urllib.request.Request(
        f"{decode_url}/admin/session/import",
        data=json.dumps({"from": prefill_url, "key": key}).encode(),
        headers=imp_headers)
    try:
        with urllib.request.urlopen(imp, timeout=timeout_s) as r:
            r.read()
    except Exception as e:  # noqa: BLE001 — source retains the session
        raise HandoffError(f"import on {decode_url} failed: {e}") from e
    try:
        fg = urllib.request.Request(
            f"{prefill_url}/admin/session/forget",
            data=json.dumps({"key": key}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(fg, timeout=10.0) as r:
            r.read()
    except Exception as e:  # noqa: BLE001 — redundant copy, harmless
        log.warning("handoff forget of %s on %s failed: %s", key,
                    prefill_url, e)
    return meta


class ClassAutoscaler:
    """Per-class elastic pools: the router's queue-driven policy, split so
    prefill and decode capacity scale INDEPENDENTLY.

    Pressure signals differ by what each class actually does:

    - **prefill** pressure per eligible replica = admission-queue depth
      (``serve_queue_depth`` — submitted-but-unadmitted requests plus
      the chunked-prefill carry backlog) + the router's own in-flight
      count toward it;
    - **decode** pressure per eligible replica = in-flight streams
      (``serve_inflight_requests``) + decode-slot occupancy
      (``serve_batch_occupancy``) — decode replicas are stream-bound,
      not queue-bound, so queue depth would read perpetually idle there.

    Each class keeps its own up/down streaks and spawns through its own
    ``spawn_fn`` (a :class:`~.router.ProcessReplicaSpawner` whose child
    env carries ``SERVE_REPLICA_CLASS``), bounded by the shared
    ``SERVE_ROUTER_AUTOSCALE_MIN``/``_MAX`` applied PER CLASS. Scale-
    down retires the least-pressured spawner-owned member through
    drain-as-migration (its parked sessions move to a peer first).
    ``mixed`` replicas are never autoscaled here — they are the
    operator's compatibility fallback. All state is scrape-thread-only
    (tick runs there exclusively); one in-flight retirement gates both
    classes (the shared event, exactly like the single-pool policy)."""

    CLASSES = ("prefill", "decode")

    def __init__(self, spawners: dict, retire_fn=None, can_retire_fn=None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 up_q: Optional[float] = None,
                 down_q: Optional[float] = None,
                 sustain: Optional[int] = None) -> None:
        self.spawners = dict(spawners)
        self.retire_fn = retire_fn
        self.can_retire_fn = can_retire_fn or (lambda url: True)
        self.min_replicas = (min_replicas if min_replicas is not None
                             else env_int("SERVE_ROUTER_AUTOSCALE_MIN", 1))
        self.max_replicas = (max_replicas if max_replicas is not None
                             else env_int("SERVE_ROUTER_AUTOSCALE_MAX", 4))
        self.up_q = (up_q if up_q is not None
                     else env_float("SERVE_ROUTER_AUTOSCALE_UP_Q", 4.0))
        self.down_q = (down_q if down_q is not None
                       else env_float("SERVE_ROUTER_AUTOSCALE_DOWN_Q", 0.5))
        self.sustain = (sustain if sustain is not None
                        else env_int("SERVE_ROUTER_AUTOSCALE_SUSTAIN", 3))
        # owned-by: tick (scrape thread) — per-class debounce streaks.
        self._up_streak = {c: 0 for c in self.CLASSES}
        self._down_streak = {c: 0 for c in self.CLASSES}
        self._retiring = threading.Event()

    def _pressure(self, cls: str, rep) -> float:
        if cls == "prefill":
            return rep.queue_depth + rep.inflight
        return rep.inflight_streams + rep.occupancy

    def tick(self, router) -> None:
        """One policy evaluation per class (scrape thread)."""
        if self._retiring.is_set():
            return                  # let the in-flight retire settle
        with router._mu:
            # One consistent snapshot of the fields the policy reads —
            # the per-replica table mutates under autoscaling.
            view = [(r, r.cls, r.alive, r.ready, r.draining, r.ever_alive,
                     r.shedding) for r in router.replicas]
        for cls in self.CLASSES:
            spawn_fn = self.spawners.get(cls)
            if spawn_fn is None:
                continue
            members = [v for v in view if v[1] == cls]
            n_capacity = sum(1 for v in members if v[2] or not v[5])
            elig = [v[0] for v in members if v[2] and v[3] and not v[4]]
            shedding = any(v[6] for v in members if v[2])
            with router._mu:
                loads = {r.index: self._pressure(cls, r) for r in elig}
                urls = {r.index: r.url for r in elig}
            pressure = sum(loads.values()) / max(1, len(elig))
            if ((pressure > self.up_q or shedding)
                    and n_capacity < self.max_replicas):
                self._up_streak[cls] += 1
                self._down_streak[cls] = 0
                if self._up_streak[cls] >= self.sustain:
                    self._up_streak[cls] = 0
                    url = spawn_fn()
                    if url:
                        rep = router.add_replica(url)
                        with router._mu:
                            # The spawn declared its class; pre-tag the
                            # table entry so capacity counts it toward
                            # THIS pool while it warms (the scrape
                            # re-resolves once /readyz answers).
                            rep.cls = cls
                        router._m_scale_up.inc()
                        log.info("autoscale up [%s]: pressure %.1f "
                                 "(shedding=%s) -> spawned %s", cls,
                                 pressure, shedding, url)
            elif (elig and not shedding and pressure < self.down_q
                    and len(elig) > self.min_replicas):
                self._down_streak[cls] += 1
                self._up_streak[cls] = 0
                if self._down_streak[cls] >= self.sustain:
                    self._down_streak[cls] = 0
                    victims = sorted(
                        (load, idx) for idx, load in loads.items()
                        if self.can_retire_fn(urls[idx]))
                    if victims:
                        _, idx = victims[0]
                        rep = next((r for r in router._replica_snapshot()
                                    if r.index == idx), None)
                        if rep is not None:
                            self._retire_async(router, rep, cls, pressure)
            else:
                self._up_streak[cls] = 0
                self._down_streak[cls] = 0

    def _retire_async(self, router, rep, cls: str,
                      pressure: float) -> None:
        """Retirement (drain-as-migration + process stop) off the
        scrape thread — identical discipline to the single-pool
        autoscaler: the routing table must stay fresh while the fleet
        changes."""
        log.info("autoscale down [%s]: pressure %.2f -> retiring replica "
                 "%d (%s)", cls, pressure, rep.index, rep.url)
        self._retiring.set()

        def _run() -> None:
            try:
                router.retire_replica(rep, stop_fn=self.retire_fn)
                router._m_scale_down.inc()
            except Exception:   # noqa: BLE001 — next tick re-evaluates
                log.exception("replica %d retirement failed", rep.index)
            finally:
                self._retiring.clear()

        threading.Thread(target=_run, daemon=True,
                         name="disagg-retire").start()

    def close(self) -> None:
        for fn in self.spawners.values():
            stop = getattr(fn, "stop_all", None)
            if callable(stop):
                stop()


def build_class_autoscaler() -> ClassAutoscaler:
    """The env path: one :class:`~.router.ProcessReplicaSpawner` per
    class on disjoint port ranges (prefill at
    ``SERVE_ROUTER_AUTOSCALE_PORT_BASE``, decode just above its
    ceiling), each child tagged via ``SERVE_REPLICA_CLASS``."""
    from .router import ProcessReplicaSpawner
    base = env_int("SERVE_ROUTER_AUTOSCALE_PORT_BASE", 11500)
    mx = env_int("SERVE_ROUTER_AUTOSCALE_MAX", 4)
    # Each class gets a HARD-BOUNDED range of 4x its replica ceiling
    # (slack for crash-leaked slots — a killed spawn's port is only
    # reaped by retire()), decode directly above prefill's. The bound
    # makes cross-range walks impossible by construction; a launcher
    # reserves the same 8x span against node/UI collisions.
    width = 4 * mx
    spawners = {
        "prefill": ProcessReplicaSpawner(
            port_base=base, max_ports=width,
            env_extra={"SERVE_REPLICA_CLASS": "prefill"}),
        "decode": ProcessReplicaSpawner(
            port_base=base + width, max_ports=width,
            env_extra={"SERVE_REPLICA_CLASS": "decode"}),
    }

    def can_retire(url: str) -> bool:
        return any(s.can_retire(url) for s in spawners.values())

    def retire(url: str) -> None:
        for s in spawners.values():
            if s.can_retire(url):
                s.retire(url)
                return

    return ClassAutoscaler(spawners, retire_fn=retire,
                           can_retire_fn=can_retire)
