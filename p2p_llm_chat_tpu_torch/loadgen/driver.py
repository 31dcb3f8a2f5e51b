"""Open-loop Poisson load driver for the chat plane.

The anti-pattern this avoids is the
closed-loop burst: N threads each wait for their own completion, so an
overloaded server throttles its own load generator and the measurement
hides exactly the overload it should expose. Here arrivals are a
*schedule*, not a reaction: a seeded Poisson process fixes every
arrival's fire time before the run starts, a pacer thread enqueues each
arrival at its scheduled time regardless of what is still in flight,
and a bounded worker pool executes them. When the server (or the pool)
stalls, arrivals keep firing on schedule and the stall surfaces where
it belongs — in the per-request trace records as queue lag and inflated
TTFT, judged by the SLO ledger (report.py) — never as silent generator
backpressure.

Every request produces a :class:`TraceRecord`: scenario, scheduled vs
actual send time, first-delta time, per-token gaps, and a terminal
status classified as ``ok`` / ``shed`` (503 with its Retry-After and
answer latency captured — the front's shed contract, which the ledger
re-asserts) / ``error`` / ``truncated`` (stream ended without a
``done`` record).

Determinism contract (pinned by tests/test_torch_loadgen.py, which also
holds it equal to the reference's schedule): one seed => one
byte-identical arrival schedule (times, scenario picks, peers,
per-request payload seeds), across runs and processes.
"""

from __future__ import annotations

import hashlib
import json
import queue
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

from ..utils.env import env_float, env_int
from ..utils.log import get_logger
from .scenarios import Endpoints, Scenario, Step

log = get_logger("loadgen")

# A shed must be answered fast to be worth anything to the client; the
# ledger asserts every 503 beat this (<100 ms at the HTTP front — the
# budget here is the client-side view).
SHED_LATENCY_BUDGET_MS = 100.0


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire at ``t`` seconds after run start."""

    t: float
    scenario: str
    peer: int
    seed: int           # per-request payload rng (schedule-derived)


@dataclass
class TraceRecord:
    """What actually happened to one arrival."""

    scenario: str
    peer: int
    sched_s: float                   # scheduled fire offset
    lag_ms: float = 0.0              # scheduled fire -> worker pickup
    status: str = "ok"               # ok | shed | error | truncated | empty
    ttft_ms: Optional[float] = None  # measured-step send -> first delta
    itl_ms: list = field(default_factory=list)   # inter-delta gaps
    tokens: int = 0
    total_ms: Optional[float] = None
    retry_after: bool = False        # shed: Retry-After header present
    shed_ms: Optional[float] = None  # shed: send -> 503 answered
    error: str = ""
    error_kind: str = ""             # http | conn | timeout | stream
    # Phase attribution (disagg_session): first-delta latency and
    # inter-delta gaps per Step.phase tag, so the ledger can split an
    # SLO miss by prefill vs decode (report.py phase_slos).
    phase_ttft_ms: dict = field(default_factory=dict)
    phase_itl_ms: dict = field(default_factory=dict)
    # grafttrace (obs/trace.py): the id stamped on every step's
    # X-Graft-Trace header — schedule-derived (deterministic per
    # arrival), so the ledger can fetch this request's server-side
    # timeline and attribute an SLO breach to its dominant phase.
    trace_id: str = ""

    def slo_ttft_ms(self) -> Optional[float]:
        """TTFT as the SLO sees it: queue lag included, so a saturated
        worker pool (or pacer drift) degrades the judged number instead
        of hiding in a side channel."""
        if self.ttft_ms is None:
            return None
        return self.ttft_ms + self.lag_ms


def build_schedule(mix: list, rate_rps: float, duration_s: float,
                   seed: int, n_peers: int) -> list:
    """Seeded open-loop Poisson schedule over a weighted scenario mix.

    ``mix``: [(Scenario, weight), ...]. Returns [Arrival, ...] sorted by
    fire time. Pure function of its arguments — the determinism leg of
    the test suite runs it twice and asserts equality.
    """
    if rate_rps <= 0 or duration_s <= 0 or n_peers <= 0:
        raise ValueError("rate, duration and n_peers must be positive")
    rng = random.Random(seed)
    total_w = sum(w for _, w in mix)
    out = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_rps)
        if t >= duration_s:
            break
        pick = rng.random() * total_w
        acc = 0.0
        chosen: Scenario = mix[-1][0]
        for s, w in mix:
            acc += w
            if pick < acc:
                chosen = s
                break
        out.append(Arrival(t=t, scenario=chosen.name,
                           peer=rng.randrange(n_peers),
                           seed=rng.getrandbits(32)))
    return out


def _extract_delta(obj: dict) -> str:
    """Delta text wherever this endpoint carries it (UI ``delta``, serve
    ``response``, chat ``message.content``)."""
    d = obj.get("delta")
    if isinstance(d, str) and d:
        return d
    r = obj.get("response")
    if isinstance(r, str) and r:
        return r
    m = obj.get("message")
    if isinstance(m, dict):
        c = m.get("content")
        if isinstance(c, str) and c:
            return c
    return ""


class LoadDriver:
    """Executes a schedule against live endpoints; collects trace records.

    The worker pool is intentionally bounded (``workers``): with more
    in-flight requests than workers, pickup lags the schedule and the
    lag lands in ``TraceRecord.lag_ms`` — visible, judged, never a
    reason for an arrival to not fire.
    """

    def __init__(self, endpoints: Endpoints, registry: dict,
                 workers: int = 0, timeout_s: float = 0.0) -> None:
        self._ep = endpoints
        self._registry = dict(registry)
        self._workers = workers or env_int("LOADGEN_WORKERS", 64)
        self._timeout_s = timeout_s or env_float("LOADGEN_TIMEOUT_S", 120.0)
        self._mu = threading.Lock()
        self._records: list = []        # guarded-by: _mu
        self._inflight: dict = {}       # guarded-by: _mu (worker id -> Arrival)
        # The work queue needs no guarded-by: queue.Queue is internally
        # locked, and the pacer is its only producer / the workers its
        # only consumers (blocking .get() with no timeout is the worker
        # park state by design — never under _mu, which the blocking
        # analyzer would flag).
        self._q: "queue.Queue" = queue.Queue()

    # -- request execution -------------------------------------------------

    def _post(self, step: Step, carry: Optional[dict] = None,
              trace: str = ""):
        payload = step.payload
        if step.use_context and carry and carry.get("context"):
            # Ollama stateless continuation: the prior step's final
            # record ids ride back in — the only request shape whose
            # follow-up token ids EXTEND a parked/migrated session.
            payload = {**payload, "context": carry["context"]}
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if step.session:
            headers["X-Session-Id"] = step.session
        if trace:
            # s=1 pins the origin's verdict: every server this arrival
            # touches records spans regardless of ITS sample rate, so a
            # breached request always has a timeline to attribute.
            headers["X-Graft-Trace"] = f"{trace};s=1"
        req = urllib.request.Request(step.url, data=data, headers=headers,
                                     method="POST")
        return urllib.request.urlopen(req, timeout=self._timeout_s)

    def _run_step(self, step: Step, rec: TraceRecord,
                  carry: Optional[dict] = None) -> bool:
        """Execute one step; fill ``rec`` if measured (always on
        failure). ``carry`` is the plan's context round-trip state
        (Step.carry_context/use_context). Returns False to abort the
        remaining steps."""
        if step.pause_before_s > 0:
            time.sleep(step.pause_before_s)
        if step.fanout > 1 and step.stream:
            return self._run_fanout(step, rec)
        t_send = time.monotonic()
        deadline = t_send + self._timeout_s
        try:
            resp = self._post(step, carry, trace=rec.trace_id)
        except urllib.error.HTTPError as e:
            lat_ms = (time.monotonic() - t_send) * 1e3
            body = b""
            try:
                body = e.read()[:300]
            except Exception:   # noqa: BLE001 — diagnostics only
                pass
            if e.code == 503:
                rec.status = "shed"
                rec.shed_ms = lat_ms
                rec.retry_after = bool(e.headers.get("Retry-After"))
            else:
                rec.status = "error"
                rec.error_kind = "http"
                rec.error = f"HTTP {e.code}: {body!r}"
            return False
        except (urllib.error.URLError, socket.timeout, ConnectionError,
                OSError) as e:
            rec.status = "error"
            # Pre-response timeouts are "conn-timeout", NOT "timeout":
            # no stream ever opened, so the chaos ledger's zero-tolerance
            # hung-stream gate must not fire on a slow connect — that
            # failure class belongs under the error-fraction budget.
            rec.error_kind = ("conn-timeout" if isinstance(
                e, (socket.timeout, TimeoutError)) else "conn")
            rec.error = str(e)
            return False

        try:
            return self._consume(step, rec, resp, t_send, deadline,
                                 carry=carry)
        finally:
            try:
                resp.close()
            except Exception:   # noqa: BLE001 — teardown only
                pass

    def _run_fanout(self, step: Step, rec: TraceRecord) -> bool:
        """The thundering-herd step (group_chat): ``fanout`` identical
        concurrent streams, judged as ONE unit — the user who triggered
        N co-pilot suggestions is served when the LAST one starts
        talking, so TTFT is the worst first-delta across the fan;
        inter-token gaps concatenate; any failed member fails the whole
        record with its own classification (a herd that half-sheds is a
        shed, not a success)."""
        sub = [TraceRecord(scenario=rec.scenario, peer=rec.peer,
                           sched_s=rec.sched_s, trace_id=rec.trace_id)
               for _ in range(step.fanout)]
        one = Step(url=step.url, payload=step.payload, stream=True,
                   measured=True, session=step.session,
                   read_delay_s=step.read_delay_s)

        def fan(r: TraceRecord) -> None:
            try:
                self._run_step(one, r)
            except Exception as e:   # noqa: BLE001 — never lose a member
                r.status = "error"
                r.error_kind = "driver"
                r.error = str(e)

        threads = [threading.Thread(target=fan, args=(r,))
                   for r in sub[1:]]
        for th in threads:
            th.start()
        fan(sub[0])
        for th in threads:
            th.join()
        bad = next((r for r in sub if r.status != "ok"), None)
        if bad is not None:
            rec.status = bad.status
            rec.error, rec.error_kind = bad.error, bad.error_kind
            rec.retry_after, rec.shed_ms = bad.retry_after, bad.shed_ms
            return False
        ttft = max((r.ttft_ms or 0.0) for r in sub)
        gaps = [g for r in sub for g in r.itl_ms]
        if step.measured:
            rec.ttft_ms = ttft
            rec.itl_ms = gaps
            rec.tokens = sum(r.tokens for r in sub)
            rec.total_ms = max((r.total_ms or 0.0) for r in sub)
        if step.phase:
            rec.phase_ttft_ms[step.phase] = ttft
            rec.phase_itl_ms.setdefault(step.phase, []).extend(gaps)
        return True

    def _consume(self, step: Step, rec: TraceRecord, resp,
                 t_send: float, deadline: float,
                 carry: Optional[dict] = None) -> bool:
        if not step.stream:
            try:
                resp.read()
            except Exception as e:   # noqa: BLE001 — one classification
                rec.status = "error"
                rec.error_kind = "conn"
                rec.error = str(e)
                return False
            if step.measured:
                rec.ttft_ms = (time.monotonic() - t_send) * 1e3
                rec.total_ms = rec.ttft_ms
            if step.phase:
                # Non-streamed step: the whole answer IS the first byte.
                rec.phase_ttft_ms[step.phase] = \
                    (time.monotonic() - t_send) * 1e3
            return True

        first: Optional[float] = None
        last: Optional[float] = None
        done = False
        gaps: list = []
        ntok = 0
        try:
            for line in resp:
                now = time.monotonic()
                if now > deadline:
                    # A stream that drips past the request wall budget is
                    # a hung stream for contract purposes — the chaos
                    # checks (chaos.py) count these.
                    rec.status = "error"
                    rec.error_kind = "timeout"
                    rec.error = "stream exceeded request wall budget"
                    return False
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if obj.get("error"):
                    rec.status = "error"
                    rec.error_kind = "stream"
                    rec.error = str(obj.get("error"))[:300]
                    return False
                delta = _extract_delta(obj)
                if delta:
                    ntok += 1
                    if first is None:
                        first = now
                    elif last is not None:
                        gaps.append((now - last) * 1e3)
                    last = now
                    if (step.abort_after_deltas
                            and ntok >= step.abort_after_deltas):
                        # Adversarial mid-stream disconnect: the caller's
                        # finally closes the socket NOW — the server sees
                        # a client gone mid-generation (the stream-close
                        # discipline must settle its gauges). The CLIENT
                        # got exactly what it wanted, so the record is
                        # ok with whatever it measured before leaving.
                        if step.measured:
                            rec.tokens = ntok
                            rec.itl_ms = gaps
                            rec.ttft_ms = (first - t_send) * 1e3
                            rec.total_ms = (now - t_send) * 1e3
                        return True
                if obj.get("done"):
                    if step.carry_context and carry is not None \
                            and obj.get("context"):
                        carry["context"] = obj["context"]
                    done = True
                    break
                if step.read_delay_s > 0:
                    # Slow reader: parking between lines backs TCP up
                    # into the server's chunk writer — the adversarial
                    # hold the slow_reader scenario exists to apply.
                    time.sleep(step.read_delay_s)
        except (socket.timeout, TimeoutError):
            rec.status = "error"
            rec.error_kind = "timeout"
            rec.error = "stream read timed out"
            return False
        except (OSError, urllib.error.URLError) as e:
            rec.status = "truncated"
            rec.error = str(e)
            return False

        if step.measured:
            rec.tokens = ntok
            rec.itl_ms = gaps
            if first is not None:
                rec.ttft_ms = (first - t_send) * 1e3
            rec.total_ms = (time.monotonic() - t_send) * 1e3
        if not done:
            # Chunked stream ended cleanly but without a terminal record:
            # the server dropped it mid-generation (the front's contract
            # makes mid-stream failure LOOK truncated on purpose).
            rec.status = "truncated"
            return False
        if step.measured and first is None:
            # Completed stream with zero deltas: the server finished
            # cleanly but emitted nothing (long_ctx near the context
            # budget legitimately does this — max_tokens resolves to 0
            # after the prompt fills the window). There is nothing to
            # hold the TTFT SLO against, but it is NOT a wire failure
            # either — its own status keeps it out of the
            # error+truncated fraction and the chaos contract's strict
            # zero-error gate (the old "error/stream" classification
            # flaked exactly those runs).
            rec.status = "empty"
            rec.error = "done without any delta"
            return False
        if step.phase and first is not None:
            # Phase attribution records for EVERY tagged step, measured
            # or not — turn 1 of disagg_session is unmeasured but its
            # first-delta latency is exactly the prefill-phase number.
            rec.phase_ttft_ms[step.phase] = (first - t_send) * 1e3
            rec.phase_itl_ms.setdefault(step.phase, []).extend(gaps)
        return True

    def _execute(self, a: Arrival, target_t: float) -> TraceRecord:
        rec = TraceRecord(scenario=a.scenario, peer=a.peer, sched_s=a.t)
        rec.lag_ms = max(0.0, (time.monotonic() - target_t) * 1e3)
        # Deterministic per-arrival trace id, derived OUTSIDE the
        # builder rng (build_schedule's draw sequence is byte-pinned by
        # the determinism tests — nothing here may consume from it).
        rec.trace_id = hashlib.sha1(
            f"{a.seed}:{a.scenario}:{a.peer}:{a.t}".encode()
        ).hexdigest()[:32]
        rng = random.Random(a.seed)
        try:
            steps = self._registry[a.scenario].build(rng, a.peer, self._ep)
        except Exception as e:   # noqa: BLE001 — a builder bug is a record
            rec.status = "error"
            rec.error_kind = "build"
            rec.error = str(e)
            return rec
        carry: dict = {}        # the plan's context round-trip state
        for step in steps:
            if not self._run_step(step, rec, carry):
                break
        return rec

    def _worker(self) -> None:
        wid = threading.get_ident()
        while True:
            item = self._q.get()
            if item is None:
                return
            a, target_t = item
            with self._mu:
                self._inflight[wid] = a
            try:
                rec = self._execute(a, target_t)
            except Exception as e:   # noqa: BLE001 — never lose a record
                rec = TraceRecord(scenario=a.scenario, peer=a.peer,
                                  sched_s=a.t, status="error",
                                  error=f"driver bug: {e}",
                                  error_kind="driver")
            with self._mu:
                self._records.append(rec)
                self._inflight.pop(wid, None)

    # -- run ---------------------------------------------------------------

    def run(self, schedule: list, chaos=None) -> list:
        """Pace the schedule open-loop; return all trace records.

        ``chaos``: optional chaos.ChaosWindow — armed/disarmed on its
        own offsets relative to the same run clock.
        """
        if not schedule:
            return []
        threads = [threading.Thread(target=self._worker, daemon=True)
                   for _ in range(min(self._workers, len(schedule)))]
        for th in threads:
            th.start()
        t0 = time.monotonic()
        if chaos is not None:
            chaos.start(t0)
        try:
            # The pacer: fire every arrival AT its scheduled time. The
            # only blocking call is the sleep to the next fire time —
            # q.put never blocks (unbounded queue; boundedness lives in
            # the worker pool where it is measurable as lag).
            for a in schedule:
                target = t0 + a.t
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                self._q.put((a, target))
        finally:
            for _ in threads:
                self._q.put(None)
            # Workers drain naturally: every in-flight request is bounded
            # by the socket timeout + wall-budget check. A plan has up to
            # two HTTP steps plus think time, so the join bound is TWICE
            # the budget with margin — and any worker still wedged past
            # that surfaces as a timeout record below, never a silently
            # missing arrival.
            deadline = time.monotonic() + 2 * self._timeout_s + 60.0
            for th in threads:
                th.join(timeout=max(0.1, deadline - time.monotonic()))
            if chaos is not None:
                chaos.stop()
        with self._mu:
            records = list(self._records)
            for a in self._inflight.values():
                records.append(TraceRecord(
                    scenario=a.scenario, peer=a.peer, sched_s=a.t,
                    status="error", error_kind="timeout",
                    error="request still in flight past the driver's "
                          "join deadline"))
        return records
