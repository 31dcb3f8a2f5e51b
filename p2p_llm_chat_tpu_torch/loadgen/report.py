"""The SLO ledger: trace records in, one BENCH-style JSON row out.

Per scenario and in aggregate: TTFT p50/p95 (queue lag included — the
open-loop driver's stall signal), inter-token p95, the shed/error
taxonomy, goodput (completions *meeting their SLO* per second — the
serving-evaluation convention), and a
pass/fail verdict against the scenario targets from scenarios.py.

Rows are durable by the same convention as the bench: the first free
``E2E_r0N.json`` slot in the repo root (``BENCH_r0N.json``'s sibling),
and a failed run writes an *error row* rather than nothing — a crashed
64-peer run that silently prints to a lost stdout is an hour of chip
time unrecorded.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from .chaos import ContractReport
from .driver import TraceRecord
from .scenarios import SLO, slo_scale

# Beyond sheds (bounded per-scenario by the SLO), a run where more than
# this fraction of a scenario's arrivals error/truncate cannot pass —
# broken is not slow. Sized ABOVE the standard armed-chaos fault rates
# (a run with stream-chaos at 2%/delta expects a few percent of
# client-visible anomalies BY DESIGN; a tighter gate would fail runs
# for injecting exactly the faults they armed).
MAX_BAD_FRAC = 0.10
# Fraction gates (shed/bad) need a minimum sample to mean anything: at
# n=2 a single pulse-shed reads as "50% shed" and fails a scenario on
# one coin flip. Below this count the fractions are still REPORTED,
# just not judged; latency percentiles are judged at any n (weak at
# small n, but never flipped by a single event the budget allows).
MIN_FRACTION_N = 8


def percentile(xs: list, p: float) -> Optional[float]:
    """Nearest-rank on the sorted sample."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


# -- SLO-breach phase attribution (grafttrace, obs/trace.py) ----------------
#
# Span-name prefix -> attribution phase. Ordered: first prefix match
# wins. ``api.request`` is deliberately ABSENT — it is the envelope
# covering queue + prefill + the whole decode stream, so counting it in
# the dominance sum would attribute every breach to "the request".
_PHASE_PREFIXES = (
    ("sched.queue_wait", "queue_wait"),
    ("sched.prefill", "prefill"),
    ("sched.wake", "wake"),
    ("sched.decode", "decode"),
    ("disagg.", "handoff"),
    ("router.route", "route"),
    ("node.", "p2p"),
)


def _span_phase(name: str) -> Optional[str]:
    for pfx, phase in _PHASE_PREFIXES:
        if name.startswith(pfx):
            return phase
    return None


def _dominant_phase(spans) -> Optional[str]:
    """The phase that ate the most wall across a merged timeline, or
    None when the timeline holds nothing attributable (evicted store,
    untraced hop). Ties break alphabetically — deterministic rows."""
    if not spans:
        return None
    sums: dict = {}
    for s in spans:
        if not isinstance(s, dict):
            continue
        phase = _span_phase(str(s.get("name") or ""))
        if phase is None:
            continue
        sums[phase] = sums.get(phase, 0.0) + float(s.get("dur_ms") or 0.0)
    if not sums:
        return None
    return min(sums.items(), key=lambda kv: (-kv[1], kv[0]))[0]


def fetch_timelines(base_url: str, timeout_s: float = 3.0):
    """A lazy, memoized ``trace_id -> spans | None`` lookup against a
    trace-listing endpoint (serve front or router ``/admin/trace`` —
    the router merges cross-replica). Lazy on purpose: the ledger only
    resolves timelines for BREACHED requests, so a clean run costs zero
    fetches; pass the returned callable as ``build_ledger``'s
    ``timelines``."""
    import urllib.error
    import urllib.parse
    import urllib.request

    cache: dict = {}

    def lookup(trace_id: str):
        if not trace_id:
            return None
        if trace_id in cache:
            return cache[trace_id]
        spans = None
        try:
            q = urllib.parse.urlencode({"id": trace_id})
            with urllib.request.urlopen(
                    f"{base_url.rstrip('/')}/admin/trace?{q}",
                    timeout=timeout_s) as r:
                doc = json.loads(r.read().decode("utf-8"))
            spans = doc.get("spans") or None
        except Exception:   # noqa: BLE001 — 404/evicted/down: no timeline
            spans = None
        cache[trace_id] = spans
        return spans

    return lookup


def _resolve_timeline(timelines, trace_id: str):
    if timelines is None or not trace_id:
        return None
    if callable(timelines):
        return timelines(trace_id)
    return timelines.get(trace_id)


def _judge_phases(recs: list, phase_slos: dict, scale: float,
                  violations: list) -> dict:
    """Per-phase latency judgement (disagg_session): aggregate each
    phase tag's first-delta latencies and inter-delta gaps across the
    scenario's ok records, judge them against that phase's SLO, and
    label any violation with the phase — so a miss reads
    ``phase[prefill]`` (admission/handoff pool) vs ``phase[decode]``
    (wake/stream pool) instead of one blended number. Latency-only:
    shed/error fractions stay whole-scenario (a shed has no phase)."""
    out: dict = {}
    for phase, slo in sorted(phase_slos.items()):
        ttfts = [r.phase_ttft_ms[phase] for r in recs
                 if r.status == "ok" and phase in r.phase_ttft_ms]
        itls: list = []
        for r in recs:
            if r.status == "ok":
                itls.extend(r.phase_itl_ms.get(phase, ()))
        p50 = percentile(ttfts, 50)
        p95 = percentile(ttfts, 95)
        itl_p95 = percentile(itls, 95)
        t_p50 = slo.ttft_p50_ms * scale
        t_p95 = slo.ttft_p95_ms * scale
        t_itl = (slo.itl_p95_ms * scale
                 if slo.itl_p95_ms is not None else None)
        if p50 is not None and p50 > t_p50:
            violations.append(
                f"phase[{phase}]: ttft_p50 {p50:.0f} ms > {t_p50:.0f} ms")
        if p95 is not None and p95 > t_p95:
            violations.append(
                f"phase[{phase}]: ttft_p95 {p95:.0f} ms > {t_p95:.0f} ms")
        if t_itl is not None and itl_p95 is not None and itl_p95 > t_itl:
            violations.append(
                f"phase[{phase}]: itl_p95 {itl_p95:.0f} ms > "
                f"{t_itl:.0f} ms")
        out[phase] = {
            "n": len(ttfts),
            "ttft_p50_ms": round(p50, 1) if p50 is not None else None,
            "ttft_p95_ms": round(p95, 1) if p95 is not None else None,
            "itl_p95_ms": (round(itl_p95, 2)
                           if itl_p95 is not None else None),
            "slo": {"ttft_p50_ms": t_p50, "ttft_p95_ms": t_p95,
                    "itl_p95_ms": t_itl},
        }
    return out


def _judge_scenario(name: str, recs: list, slo: SLO, duration_s: float,
                    scale: float, phase_slos: Optional[dict] = None,
                    timelines=None) -> dict:
    n = len(recs)
    by = {s: sum(1 for r in recs if r.status == s)
          for s in ("ok", "shed", "error", "truncated", "empty")}
    ttfts = [r.slo_ttft_ms() for r in recs
             if r.status == "ok" and r.slo_ttft_ms() is not None]
    itls: list = []
    for r in recs:
        if r.status == "ok":
            itls.extend(r.itl_ms)
    p50 = percentile(ttfts, 50)
    p95 = percentile(ttfts, 95)
    itl_p95 = percentile(itls, 95)
    shed_frac = by["shed"] / n if n else 0.0
    bad_frac = (by["error"] + by["truncated"]) / n if n else 0.0

    t_p50 = slo.ttft_p50_ms * scale
    t_p95 = slo.ttft_p95_ms * scale
    t_itl = slo.itl_p95_ms * scale if slo.itl_p95_ms is not None else None
    violations = []
    if n == 0:
        pass    # nothing arrived for this scenario: vacuous pass
    elif not ttfts:
        # All arrivals shed/errored. At a judgeable sample size that is
        # a dead scenario; below MIN_FRACTION_N it is the same
        # coin-flip problem as the fraction gates (e.g. 3 arrivals all
        # landing inside the chaos pulse) — reported, not judged.
        if n >= MIN_FRACTION_N:
            violations.append("no completion survived to judge")
    else:
        if p50 is not None and p50 > t_p50:
            violations.append(f"ttft_p50 {p50:.0f} ms > {t_p50:.0f} ms")
        if p95 is not None and p95 > t_p95:
            violations.append(f"ttft_p95 {p95:.0f} ms > {t_p95:.0f} ms")
        if t_itl is not None and itl_p95 is not None and itl_p95 > t_itl:
            violations.append(f"itl_p95 {itl_p95:.0f} ms > {t_itl:.0f} ms")
    if n >= MIN_FRACTION_N and shed_frac > slo.max_shed_frac:
        violations.append(
            f"shed_frac {shed_frac:.2f} > {slo.max_shed_frac:.2f}")
    if n >= MIN_FRACTION_N and bad_frac > MAX_BAD_FRAC:
        violations.append(f"error+truncated frac {bad_frac:.2f} > "
                          f"{MAX_BAD_FRAC:.2f}")

    # Goodput: completions that individually met the SLO, per second of
    # scheduled run time. Completions that MISSED it are the breached
    # set the phase-attribution pass below explains.
    good = 0
    breached = []   # (record, bad_ttft, bad_itl)
    for r in recs:
        if r.status != "ok":
            continue
        t = r.slo_ttft_ms()
        bad_ttft = t is None or t > t_p95
        own_itl = percentile(r.itl_ms, 95)
        bad_itl = (t_itl is not None and own_itl is not None
                   and own_itl > t_itl)
        if bad_ttft or bad_itl:
            breached.append((r, bad_ttft, bad_itl))
            continue
        good += 1

    # Breach attribution (grafttrace): for every ok-but-SLO-missing
    # request, pull its merged server-side timeline and name the phase
    # that dominated. A request whose timeline is gone (store evicted,
    # replica dead, tracing off) still carries attribution — the
    # client-side fallback names WHICH budget it blew, just not where.
    attribution = None
    if breached:
        by_phase: dict = {}
        for r, bad_ttft, bad_itl in breached:
            spans = _resolve_timeline(timelines,
                                      getattr(r, "trace_id", ""))
            phase = _dominant_phase(spans)
            if phase is None:
                phase = "client_ttft" if bad_ttft else "client_itl"
            by_phase[phase] = by_phase.get(phase, 0) + 1
        attribution = {
            "n_breached": len(breached),
            "by_phase": dict(sorted(by_phase.items(),
                                    key=lambda kv: (-kv[1], kv[0]))),
        }

    phases = None
    if phase_slos:
        phases = _judge_phases(recs, phase_slos, scale, violations)

    bad_kinds: dict = {}
    for r in recs:
        if r.status in ("error", "truncated"):
            k = r.error_kind or r.status
            bad_kinds[k] = bad_kinds.get(k, 0) + 1
    return {
        "phases": phases,
        "n": n, "ok": by["ok"], "shed": by["shed"], "error": by["error"],
        "truncated": by["truncated"],
        # Clean completions that streamed zero deltas (a near-budget
        # long_ctx turn): counted on their own, NEVER in bad_frac —
        # they are a workload property, not a wire failure.
        "empty": by["empty"],
        "bad_kinds": bad_kinds,
        "ttft_p50_ms": round(p50, 1) if p50 is not None else None,
        "ttft_p95_ms": round(p95, 1) if p95 is not None else None,
        "itl_p95_ms": round(itl_p95, 2) if itl_p95 is not None else None,
        "lag_p95_ms": round(percentile(
            [r.lag_ms for r in recs], 95) or 0.0, 1) if n else None,
        "tokens": sum(r.tokens for r in recs),
        "shed_frac": round(shed_frac, 4),
        "goodput_rps": round(good / duration_s, 3) if duration_s else None,
        "breach_attribution": attribution,
        "slo": {"ttft_p50_ms": t_p50, "ttft_p95_ms": t_p95,
                "itl_p95_ms": t_itl, "max_shed_frac": slo.max_shed_frac},
        "pass": not violations,
        "violations": violations,
    }


def build_ledger(records: list, registry: dict, duration_s: float,
                 meta: Optional[dict] = None,
                 contract: Optional[ContractReport] = None,
                 timelines=None) -> dict:
    """All trace records -> the run's ledger row (JSON-serialisable).

    ``timelines``: optional ``trace_id -> spans`` lookup — a plain dict
    (tests) or the lazy callable from :func:`fetch_timelines` — used to
    attribute each SLO-breached request to its dominant server phase.
    """
    scale = slo_scale()
    per: dict = {}
    for name, scen in registry.items():
        recs = [r for r in records if r.scenario == name]
        per[name] = _judge_scenario(name, recs, scen.slo, duration_s,
                                    scale,
                                    phase_slos=getattr(scen, "phase_slos",
                                                       None),
                                    timelines=timelines)

    n = len(records)
    ok = sum(1 for r in records if r.status == "ok")
    shed = sum(1 for r in records if r.status == "shed")
    bad = sum(1 for r in records if r.status in ("error", "truncated"))
    empty = sum(1 for r in records if r.status == "empty")
    failures = [f"{name}: {v}" for name, s in sorted(per.items())
                for v in s["violations"]]
    if contract is not None:
        failures.extend(f"chaos: {v}" for v in contract.violations)
    row = {
        "metric": "loadgen_e2e",
        "schema": 1,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "duration_s": round(duration_s, 2),
        "arrivals": n,
        "ok": ok, "shed": shed, "bad": bad, "empty": empty,
        "shed_frac": round(shed / n, 4) if n else None,
        "goodput_rps": round(sum(
            s["goodput_rps"] or 0.0 for s in per.values()), 3),
        "slo_scale": scale,
        "scenarios": per,
        "chaos": contract.to_dict() if contract is not None else None,
        "verdict": "pass" if (not failures and n > 0) else "fail",
        "failures": failures,
    }
    if meta:
        row.update(meta)
    return row


def next_row_path(directory: str, prefix: str = "E2E") -> str:
    """First free ``<prefix>_r0N.json`` slot — the BENCH_r0N convention."""
    for i in range(1, 100):
        p = os.path.join(directory, f"{prefix}_r{i:02d}.json")
        if not os.path.exists(p):
            return p
    raise RuntimeError(f"no free {prefix}_rNN.json slot in {directory}")


def write_row(row: dict, directory: str, prefix: str = "E2E") -> str:
    path = next_row_path(directory, prefix)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(row, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return path


def error_row(exc: BaseException, meta: Optional[dict] = None) -> dict:
    row = {
        "metric": "loadgen_e2e",
        "schema": 1,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "verdict": "error",
        "error": f"{type(exc).__name__}: {exc}",
    }
    if meta:
        row.update(meta)
    return row
