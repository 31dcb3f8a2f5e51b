"""In-tree failpoint registry: stack-wide fault injection — a copy of
p2p_llm_chat_tpu/utils/failpoints.py (the port imports nothing of the
reference package), with the same grammar, sites and counters.

Every layer of the serve + P2P planes threads named sites through this
module (``failpoint("site.name")``) — a no-op by default, armable from
the environment or at runtime to inject the faults the chaos suites
drive (tests/test_failpoints.py). The practice follows FreeBSD's
``fail(9)`` / TiKV's ``fail-rs``: partial failure is a first-class,
*tested* behavior, not an emergent one — every site has a test that
arms it and asserts the degradation contract (no deadlock, well-formed
error or recovery, oracle-exact completed greedy output).

Arming grammar (``FAIL_POINTS`` env var or :func:`arm`)::

    site=action[:arg][*count][@prob]

comma- or semicolon-separated entries. Actions:

- ``raise[:MSG]``   raise :class:`FailpointError` at the site (the
  caller's existing error path must degrade gracefully);
- ``delay:MS``      sleep MS milliseconds, then continue (latency
  injection — slow disks, slow networks, GC pauses);
- ``drop``          the caller discards the current item (a lost
  datagram, a dropped control frame) — sites that support it check the
  returned action's ``kind``;
- ``error[:MSG]``   the caller returns a well-formed error instead of
  proceeding (an HTTP 500 record, a refused RPC) — also checked via
  the returned action.

Modifiers: ``*N`` fires only the first N hits then self-disarms
(deterministic one-shot faults for recovery tests); ``@P`` fires with
probability P in [0, 1] (background fault rates for chaos runs).

Hit counters are per-site, monotonic, and exported on the serve front's
``/metrics`` as ``failpoint_hits_total{site="..."}`` (serve/api.py) —
a chaos run can assert its faults actually fired, and an operator can
see that a production binary has NO armed sites (no series present).

The disarmed fast path is one dict lookup — cheap enough for the decode
loop's per-tick sites.

Site catalog (``KNOWN_SITES``, equal to the reference's, so
docs/robustness.md documents each site's degradation contract for the
port too; the port's serving plane threads the ``serve.api.*``,
``serve.scheduler.*`` and ``serve.engine.readback`` sites):

===========================  ===============================================
``serve.api.parse``          request parse/validate in the HTTP front
``serve.api.stream``         per-delta NDJSON stream yield
``serve.scheduler.admit``    admission prefill dispatch
``serve.scheduler.dispatch`` decode-tick dispatch
``serve.scheduler.promote``  off-thread prefix-promotion build
``serve.engine.readback``    decode-tick token readback (device -> host)
``serve.kv_tier.export``     session-payload serialize for a peer replica
``serve.kv_tier.import``     session-payload install from a peer replica
``serve.router.migrate``     one session's drain/retire migration step
``serve.disagg.handoff``     one prefill→decode handoff (router side)

``p2p.directory.register``   directory client register RPC
``p2p.directory.lookup``     directory client lookup RPC
``p2p.directory.evict``      directory TTL eviction of one stale record
``p2p.dht.rpc``              one DHT UDP RPC attempt (drop = lost dgram)
``p2p.relay.control``        relay-service control-frame handling
``p2p.transport.handshake``  secure-channel dial handshake
``p2p.node.deliver``         one chat-message delivery attempt (per addr)
``p2p.node.resolve``         redelivery-round recipient re-resolution
===========================  ===============================================
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from .env import env_or
from .log import get_logger

log = get_logger("failpoints")

KNOWN_SITES = (
    "serve.api.parse",
    "serve.api.stream",
    "serve.scheduler.admit",
    "serve.scheduler.dispatch",
    "serve.scheduler.promote",
    "serve.engine.readback",
    "serve.kv_tier.export",
    "serve.kv_tier.import",
    "serve.router.migrate",
    "serve.disagg.handoff",
    "p2p.directory.register",
    "p2p.directory.lookup",
    "p2p.directory.evict",
    "p2p.dht.rpc",
    "p2p.relay.control",
    "p2p.transport.handshake",
    "p2p.node.deliver",
    "p2p.node.resolve",
)

_ACTIONS = ("raise", "delay", "drop", "error")


class FailpointError(RuntimeError):
    """Raised at a site armed with the ``raise`` action. Subclasses
    RuntimeError so every existing degrade-don't-crash handler (the
    scheduler's recovery envelope, the router's 500 mapping, the node's
    lookup-ladder fallbacks) treats it like any unexpected fault."""


@dataclass
class Action:
    """One armed site's behavior. Returned from :func:`failpoint` for
    the caller-interpreted kinds (``drop``/``error``); ``raise`` and
    ``delay`` are handled inside the registry."""

    kind: str
    msg: str = ""
    delay_s: float = 0.0
    remaining: int = -1            # *N modifier; -1 = unlimited
    prob: float = 1.0              # @P modifier


_mu = threading.Lock()
_armed: dict[str, Action] = {}     # guarded-by: _mu (reads are lock-free:
#                                    per-site get of an immutable-enough
#                                    entry; mutation always under _mu)
_hits: dict[str, int] = {}         # guarded-by: _mu
_env_loaded = False


def parse_spec(spec: str) -> Action:
    """``action[:arg][*count][@prob]`` -> :class:`Action` (ValueError on
    anything malformed — a typo'd chaos config must fail loudly, not
    silently not inject)."""
    prob = 1.0
    remaining = -1
    body = spec.strip()
    if "@" in body:
        body, _, p = body.rpartition("@")
        prob = float(p)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"failpoint prob must be in [0,1]: {spec!r}")
    if "*" in body:
        body, _, n = body.rpartition("*")
        remaining = int(n)
        if remaining < 1:
            raise ValueError(f"failpoint count must be >= 1: {spec!r}")
    kind, _, arg = body.partition(":")
    kind = kind.strip()
    if kind not in _ACTIONS:
        raise ValueError(
            f"unknown failpoint action {kind!r} (expected one of "
            f"{'/'.join(_ACTIONS)}): {spec!r}")
    delay_s = 0.0
    msg = ""
    if kind == "delay":
        if not arg:
            raise ValueError(f"delay needs milliseconds: {spec!r}")
        delay_s = float(arg) / 1e3
    else:
        msg = arg
    return Action(kind=kind, msg=msg, delay_s=delay_s,
                  remaining=remaining, prob=prob)


def arm(site: str, spec: str) -> None:
    """Arm ``site`` with ``spec`` (see module docstring grammar). A site
    outside :data:`KNOWN_SITES` arms with a WARNING, not an error —
    tests arm ad-hoc sites freely, but a typo'd production site would
    otherwise silently inject nothing."""
    act = parse_spec(spec)
    if site not in KNOWN_SITES:
        log.warning("failpoint site %r is not in the known-site catalog "
                    "(typo? see docs/robustness.md); arming anyway", site)
    with _mu:
        _armed[site] = act
    log.info("failpoint armed: %s=%s", site, spec)


def disarm(site: str) -> None:
    with _mu:
        _armed.pop(site, None)


def disarm_all() -> None:
    with _mu:
        _armed.clear()


def reset_hits() -> None:
    with _mu:
        _hits.clear()


def hits(site: str) -> int:
    with _mu:
        return _hits.get(site, 0)


def snapshot() -> dict[str, int]:
    """Per-site hit counters (sites that ever fired), for /metrics."""
    with _mu:
        return dict(_hits)


def armed_sites() -> tuple[str, ...]:
    with _mu:
        return tuple(sorted(_armed))


def load_env(force: bool = False) -> None:
    """Parse ``FAIL_POINTS`` once (lazily on the first failpoint() of
    the process, eagerly from every service constructor — OllamaServer,
    ChatNode, DirectoryService, RelayService — so a malformed config
    fails AT BOOT, visibly, not at some arbitrary deep call site mid-
    serving). All-or-nothing: every entry parses before any arms, so a
    typo in entry 3 can never leave entries 1-2 partially armed.
    ``force`` re-reads — tests and long-lived operators re-arming at
    runtime use :func:`arm` instead."""
    global _env_loaded
    if _env_loaded and not force:
        return
    _env_loaded = True
    raw = env_or("FAIL_POINTS", "")
    if not raw:
        return
    parsed: list[tuple[str, str]] = []
    for entry in raw.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, spec = entry.partition("=")
        if not sep:
            raise ValueError(
                f"FAIL_POINTS entry {entry!r} is not site=action")
        parse_spec(spec)                   # validate BEFORE arming any
        parsed.append((site.strip(), spec))
    for site, spec in parsed:
        arm(site, spec)


def failpoint(site: str) -> Optional[Action]:
    """Evaluate the named site. No-op (None) unless armed. ``raise``
    raises :class:`FailpointError`; ``delay`` sleeps then returns the
    action; ``drop``/``error`` return the action for the caller to
    interpret. Every fire increments the site's hit counter."""
    if not _env_loaded:
        load_env()
    act = _armed.get(site)
    if act is None:
        return None
    with _mu:
        # Re-check under the lock: a *N arm racing two threads must fire
        # exactly N times total.
        act = _armed.get(site)
        if act is None:
            return None
        if act.prob < 1.0:
            import random
            if random.random() >= act.prob:
                return None
        if act.remaining == 0:
            _armed.pop(site, None)
            return None
        if act.remaining > 0:
            act.remaining -= 1
            if act.remaining == 0:
                _armed.pop(site, None)
        _hits[site] = _hits.get(site, 0) + 1
    if act.kind == "raise":
        raise FailpointError(
            act.msg or f"failpoint {site!r} armed (injected fault)")
    if act.kind == "delay":
        time.sleep(act.delay_s)
    return act
