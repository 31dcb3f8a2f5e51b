"""Chaos-under-load: arm failpoints during a run, then hold the line.

Two halves:

- :class:`ChaosWindow` arms a ``FAIL_POINTS``-grammar spec (utils/
  failpoints.py) at ``arm_at_s`` into the run and disarms at
  ``disarm_at_s`` — for drivers sharing a process with the servers
  (stub tests, in-process engines). Multi-process runs instead pass the
  spec through the launcher environment (tools/e2e_bench.py does this)
  and use a window with ``in_process=False`` so the ledger still knows
  which records flew under chaos.

- :func:`check_contracts` re-asserts the serving front's degradation contracts
  *under load* from the driver's trace records:

  1. every shed answered fast (< ``SHED_LATENCY_BUDGET_MS``) and
     carrying ``Retry-After`` — backpressure a client can act on;
  2. no hung streams — no OPENED request ran into the wall budget
     (driver ``error_kind == "timeout"``: an in-stream stall or a
     request wedged past the join deadline; pre-response connect
     timeouts are ``conn-timeout`` and belong to the error-fraction
     budget instead);
  3. recovery after disarm — requests scheduled after
     ``disarm_at_s + grace`` complete clean (ok, or a well-formed shed;
     never error/truncated).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from ..utils import failpoints as _failpoints
from ..utils.log import get_logger
from .driver import SHED_LATENCY_BUDGET_MS, TraceRecord

log = get_logger("loadgen.chaos")


def parse_fail_points(spec: str) -> list:
    """``FAIL_POINTS`` grammar -> [(site, action_spec), ...], validated
    all-or-nothing exactly like utils.failpoints.load_env."""
    parsed = []
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, action = entry.partition("=")
        if not sep:
            raise ValueError(f"chaos entry {entry!r} is not site=action")
        _failpoints.parse_spec(action)
        parsed.append((site.strip(), action))
    return parsed


class ChaosWindow:
    """Arm ``spec`` for [arm_at_s, disarm_at_s) of a driver run."""

    def __init__(self, spec: str, arm_at_s: float = 0.0,
                 disarm_at_s: Optional[float] = None,
                 in_process: bool = True) -> None:
        self.spec = spec
        self.arm_at_s = arm_at_s
        self.disarm_at_s = disarm_at_s
        self.in_process = in_process
        self._entries = parse_fail_points(spec) if spec else []
        self._timers: list = []
        self._done = threading.Event()

    def _arm(self) -> None:
        for site, action in self._entries:
            _failpoints.arm(site, action)
        log.info("chaos armed: %s", self.spec)

    def _disarm(self) -> None:
        for site, _ in self._entries:
            _failpoints.disarm(site)
        log.info("chaos disarmed")

    def start(self, t0: float) -> None:   # t0 unused: offsets are relative
        if not self.in_process or not self._entries:
            return
        t_arm = threading.Timer(self.arm_at_s, self._arm)
        t_arm.daemon = True
        t_arm.start()
        self._timers.append(t_arm)
        if self.disarm_at_s is not None:
            t_dis = threading.Timer(self.disarm_at_s, self._disarm)
            t_dis.daemon = True
            t_dis.start()
            self._timers.append(t_dis)

    def stop(self) -> None:
        if self._done.is_set():
            return
        self._done.set()
        for t in self._timers:
            t.cancel()
        if self.in_process and self._entries:
            self._disarm()


class ChurnWindow:
    """Fleet churn mid-run: drain a replica at ``drain_at_s`` into the
    run and undrain it at ``undrain_at_s`` — through the router's
    ``/admin/drain``/``undrain``, so the drain is a LIVE MIGRATION
    (serve/router.py) and the churn scenario's sessions must
    survive it. ``drain_fn``/``undrain_fn`` override the HTTP default
    for harsher churn (kill/respawn a replica process, stop/start an
    in-process server) — the contract is the same: zero session loss,
    no client-visible errors beyond well-formed sheds.

    Same lifecycle discipline as :class:`ChaosWindow`: daemon timers
    relative to the driver's run start, ``stop()`` cancels pending
    timers and restores (undrains) if the window is still open."""

    def __init__(self, router_url: str = "", replica=0,
                 drain_at_s: float = 0.0,
                 undrain_at_s: Optional[float] = None,
                 drain_fn=None, undrain_fn=None) -> None:
        self.router_url = router_url.rstrip("/")
        self.replica = replica
        self.drain_at_s = drain_at_s
        self.undrain_at_s = undrain_at_s
        self._drain_fn = drain_fn or (lambda: self._post("drain"))
        self._undrain_fn = undrain_fn or (lambda: self._post("undrain"))
        self._timers: list = []
        self._drained = threading.Event()
        self._restored = threading.Event()
        self._done = threading.Event()

    def _post(self, verb: str) -> None:
        import json
        import urllib.request
        req = urllib.request.Request(
            f"{self.router_url}/admin/{verb}",
            data=json.dumps({"replica": self.replica}).encode(),
            headers={"Content-Type": "application/json"})
        # Drain-as-migration is synchronous server-side: the timeout
        # covers park-all + payload pulls for a loaded replica.
        with urllib.request.urlopen(req, timeout=120.0) as r:
            r.read()

    def _drain(self) -> None:
        try:
            self._drain_fn()
            self._drained.set()
            log.info("churn: replica %s drained (migration complete)",
                     self.replica)
        except Exception:   # noqa: BLE001 — churn is best-effort chaos
            log.exception("churn drain failed")

    def _undrain(self) -> None:
        try:
            self._undrain_fn()
            self._restored.set()
            log.info("churn: replica %s undrained", self.replica)
        except Exception:   # noqa: BLE001
            log.exception("churn undrain failed")

    def start(self, t0: float) -> None:   # t0 unused: offsets are relative
        t = threading.Timer(self.drain_at_s, self._drain)
        t.daemon = True
        t.start()
        self._timers.append(t)
        if self.undrain_at_s is not None:
            t2 = threading.Timer(self.undrain_at_s, self._undrain)
            t2.daemon = True
            t2.start()
            self._timers.append(t2)

    def stop(self) -> None:
        if self._done.is_set():
            return
        self._done.set()
        for t in self._timers:
            t.cancel()
        if self._drained.is_set() and not self._restored.is_set():
            self._undrain()

    @property
    def churned(self) -> bool:
        """Did the drain actually land (the run exercised churn)?"""
        return self._drained.is_set()


class NodeChurnWindow:
    """Peer churn mid-run: KILL a chat node at ``kill_at_s`` into the
    run and RESTART it at ``restart_at_s`` — the harsher cousin of
    :class:`ChurnWindow`'s drain/undrain, aimed at the chat plane
    instead of the serve fleet. A killed node takes its inbox HTTP
    front AND its P2P listener down cold, so senders fall onto the
    at-least-once outbox path (node.py): ``/send`` answers a
    well-formed ``{"status":"queued"}`` 200, and the redelivery worker
    lands the message once the peer returns.

    ``kill_fn``/``restart_fn`` are the window's whole mechanism —
    nodes have no drain admin, so there is no HTTP default: an
    in-process test passes ``ChatNode.stop`` / rebuild-and-start
    thunks, the e2e bench kills and respawns the real ``python -m
    p2p_llm_chat_tpu_torch.node`` process (tools/e2e_bench.py). The
    delivery contract asserted around the window
    (:func:`check_churn_delivery`): zero lost messages for peers
    restarting inside the outbox TTL, zero duplicates (receiver-side
    msg_id dedup), bounded redelivery delay.

    Same lifecycle discipline as :class:`ChurnWindow`: daemon timers
    relative to the driver's run start; ``stop()`` cancels pending
    timers and restarts the node if the window is still open (a run
    must never leak a dead peer past its own teardown)."""

    def __init__(self, kill_fn, restart_fn, peer=0,
                 kill_at_s: float = 0.0,
                 restart_at_s: Optional[float] = None) -> None:
        self.peer = peer
        self.kill_at_s = kill_at_s
        self.restart_at_s = restart_at_s
        self._kill_fn = kill_fn
        self._restart_fn = restart_fn
        self._timers: list = []
        self._killed = threading.Event()
        self._restored = threading.Event()
        self._done = threading.Event()

    def _kill(self) -> None:
        try:
            self._kill_fn()
            self._killed.set()
            log.info("node churn: peer %s killed", self.peer)
        except Exception:   # noqa: BLE001 — churn is best-effort chaos
            log.exception("node churn kill failed")

    def _restart(self) -> None:
        try:
            self._restart_fn()
            self._restored.set()
            log.info("node churn: peer %s restarted", self.peer)
        except Exception:   # noqa: BLE001
            log.exception("node churn restart failed")

    def start(self, t0: float) -> None:   # t0 unused: offsets are relative
        t = threading.Timer(self.kill_at_s, self._kill)
        t.daemon = True
        t.start()
        self._timers.append(t)
        if self.restart_at_s is not None:
            t2 = threading.Timer(self.restart_at_s, self._restart)
            t2.daemon = True
            t2.start()
            self._timers.append(t2)

    def stop(self) -> None:
        if self._done.is_set():
            return
        self._done.set()
        for t in self._timers:
            t.cancel()
        if self._killed.is_set() and not self._restored.is_set():
            self._restart()

    @property
    def churned(self) -> bool:
        """Did the kill actually land (the run exercised peer churn)?"""
        return self._killed.is_set()


def check_churn_delivery(sent: list, delivered: list) -> dict:
    """The peer_churn delivery oracle: every sent body delivered
    EXACTLY once — at-least-once redelivery (node.py Outbox) plus
    receiver-side msg_id dedup (inbox.py) must compose to
    exactly-once for any peer that returned inside the outbox TTL.

    ``sent`` is the bodies the senders dispatched (each send listed
    once), ``delivered`` the bodies drained from recipient inboxes.
    Returns ``{"ok", "lost", "duplicated"}`` — ``lost`` are sent
    bodies that never arrived, ``duplicated`` bodies that arrived
    more times than they were sent."""
    from collections import Counter
    want = Counter(sent)
    got = Counter(delivered)
    lost = sorted((want - got).elements())
    dup = sorted(body for body, n in got.items()
                 if n > want.get(body, 0))
    return {"ok": not lost and not dup, "lost": lost, "duplicated": dup}


@dataclass
class ContractReport:
    sheds: int = 0
    sheds_with_retry_after: int = 0
    shed_max_ms: float = 0.0
    sheds_fast: bool = True
    hung_streams: int = 0
    post_disarm_bad: int = 0
    recovery_checked: bool = False
    ok: bool = True
    violations: tuple = ()

    def to_dict(self) -> dict:
        return {
            "sheds": self.sheds,
            "sheds_with_retry_after": self.sheds_with_retry_after,
            "shed_max_ms": round(self.shed_max_ms, 1),
            "hung_streams": self.hung_streams,
            "post_disarm_bad": self.post_disarm_bad,
            "recovery_checked": self.recovery_checked,
            "ok": self.ok,
            "violations": list(self.violations),
        }


def check_contracts(records: list, disarm_at_s: Optional[float] = None,
                    recovery_grace_s: float = 2.0,
                    shed_budget_ms: Optional[float] = None) -> ContractReport:
    """Assert the degradation contracts over a run's trace records.

    ``shed_budget_ms`` defaults to the 100 ms contract scaled by
    ``LOADGEN_SLO_SCALE`` — the same host-profile scaling every other
    client-side latency target gets (a 2-core container serving 128
    processes puts a scheduler-starvation floor under EVERY response,
    503s included; on real serving hosts scale is 1.0 and the strict
    100 ms stands)."""
    from .scenarios import slo_scale
    if shed_budget_ms is None:
        shed_budget_ms = SHED_LATENCY_BUDGET_MS * slo_scale()
    rep = ContractReport()
    violations = []
    for r in records:
        assert isinstance(r, TraceRecord)
        if r.status == "shed":
            rep.sheds += 1
            if r.retry_after:
                rep.sheds_with_retry_after += 1
            if r.shed_ms is not None:
                rep.shed_max_ms = max(rep.shed_max_ms, r.shed_ms)
        if r.error_kind == "timeout":
            rep.hung_streams += 1
        if (disarm_at_s is not None
                and r.sched_s >= disarm_at_s + recovery_grace_s
                and r.status in ("error", "truncated")):
            rep.post_disarm_bad += 1
    rep.recovery_checked = disarm_at_s is not None
    if rep.sheds and rep.sheds_with_retry_after < rep.sheds:
        violations.append(
            f"{rep.sheds - rep.sheds_with_retry_after}/{rep.sheds} sheds "
            "missing Retry-After")
    if rep.shed_max_ms > shed_budget_ms:
        rep.sheds_fast = False
        violations.append(
            f"slowest shed answered in {rep.shed_max_ms:.0f} ms "
            f"(budget {shed_budget_ms:.0f} ms)")
    if rep.hung_streams:
        violations.append(f"{rep.hung_streams} hung stream(s) hit the "
                          "request wall budget")
    if rep.post_disarm_bad:
        violations.append(
            f"{rep.post_disarm_bad} request(s) scheduled after chaos "
            "disarm (+grace) still failed — no recovery")
    rep.violations = tuple(violations)
    rep.ok = not violations
    return rep
