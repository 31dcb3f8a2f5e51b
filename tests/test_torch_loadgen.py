"""The port's loadgen (p2p_llm_chat_tpu_torch/loadgen/) — the twin of
tests/test_loadgen.py, each of its legs on the port's modules, plus
cross-package cases that hold the port against the reference on the
same inputs.

No chip, no launcher: the stub (loadgen/stub.py) stands in for every
wire surface with deterministic, counter-keyed misbehavior. The legs
pin exactly what the ledger's numbers mean:

- seeded arrival-schedule determinism (the reproducibility contract);
- scenario-mix proportions under the weighted pick;
- nearest-rank percentile math and the per-scenario verdict;
- shed (503 + Retry-After, fast) vs error (500) vs truncated
  (stream without a terminal record) classification;
- the OPEN-LOOP property: a stalled server inflates TTFT while
  arrivals keep firing on schedule — never generator backpressure;
- chaos window arm/disarm and the degradation-contract checks;
- the churn window against the port's router, the slow-reader storm
  against the port's front.

Cross-package (exact: these are pure functions of their inputs): the
seeded schedule for seeds 0 and 1, ``parse_mix``, ``percentile``,
``check_contracts``, ``build_ledger`` over the same synthetic records
(``recorded_at`` aside), and ``REGISTRY`` field by field with each
builder's steps on the same seeded rng. Then one driver run against
the port's ``OllamaServer(FakeLLM)`` front and one against the port's
``ReplicaRouter`` over two such fronts, and the twin CLI's ``--stub
--duration 3`` row beside the reference CLI's (equal keys). The bench's
quote checkpoint cache (``E2E_CKPT_DIR``) rebuilds a directory the
reference left and reuses its own.

The slow leg at the bottom is the real thing in miniature: a 4-peer
full stack (directory + the port's tiny engine on the CPU, serving an HF
quote checkpoint written by models/weights.save_checkpoint + nodes +
UIs) through the twin CLI with failpoints armed at low probability,
asserting a durable E2E row with a computed verdict.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys
import time

import pytest

from p2p_llm_chat_tpu_torch.loadgen import (
    ChaosWindow, Endpoints, LoadDriver, REGISTRY, SLO, Scenario,
    StubServer, TraceRecord, build_ledger, build_schedule,
    check_contracts, default_mix, error_row, parse_mix, percentile,
    write_row)
from p2p_llm_chat_tpu_torch.utils import failpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def stub():
    servers = []

    def make(**kw):
        s = StubServer(**kw).start()
        servers.append(s)
        return s

    yield make
    for s in servers:
        s.stop()


def _endpoints(s, n=4):
    return Endpoints(serve_url=s.url, ui_urls=(s.url,) * n,
                     node_urls=(s.url,) * n,
                     users=tuple(f"peer{i:02d}" for i in range(n)))


def _serve_only(s):
    return Endpoints(serve_url=s.url)


# -- schedule ----------------------------------------------------------------

def test_schedule_deterministic_across_runs():
    a = build_schedule(default_mix(), rate_rps=25, duration_s=4.0,
                       seed=42, n_peers=16)
    b = build_schedule(default_mix(), rate_rps=25, duration_s=4.0,
                       seed=42, n_peers=16)
    assert a == b                       # times, scenarios, peers, seeds
    assert len(a) > 40
    assert all(x.t < y.t for x, y in zip(a, a[1:]))
    assert all(0 <= x.peer < 16 for x in a)
    c = build_schedule(default_mix(), rate_rps=25, duration_s=4.0,
                       seed=43, n_peers=16)
    assert c != a                       # the seed actually matters


def test_scenario_mix_proportions():
    mix = parse_mix("short_chat=3,embed=1")
    sched = build_schedule(mix, rate_rps=200, duration_s=4.0, seed=7,
                           n_peers=8)
    n = len(sched)
    frac = sum(1 for a in sched if a.scenario == "short_chat") / n
    assert n > 500
    assert 0.70 < frac < 0.80           # 3:1 weights -> 0.75 expected


def test_parse_mix_rejects_unknown_and_bad_weights():
    with pytest.raises(ValueError, match="unknown scenario"):
        parse_mix("no_such_scenario=1")
    with pytest.raises(ValueError, match="weight"):
        parse_mix("embed=0")
    assert [s.name for s, _ in parse_mix("")] == list(REGISTRY)


# -- ledger math -------------------------------------------------------------

def test_percentile_nearest_rank():
    xs = [10.0, 20.0, 30.0, 40.0]
    assert percentile(xs, 50) == 30.0   # round(0.5*3)=2 -> xs[2]
    assert percentile(xs, 95) == 40.0
    assert percentile(xs, 0) == 10.0
    assert percentile([7.0], 95) == 7.0
    assert percentile([], 50) is None


def _rec(scenario, ttft, status="ok", itl=(), lag=0.0, **kw):
    return TraceRecord(scenario=scenario, peer=0, sched_s=0.0,
                       lag_ms=lag, status=status, ttft_ms=ttft,
                       itl_ms=list(itl), **kw)


def _registry_one(name="s", **slo):
    defaults = dict(ttft_p50_ms=100, ttft_p95_ms=200, itl_p95_ms=50,
                    max_shed_frac=0.2)
    defaults.update(slo)
    return {name: Scenario(name, 1.0, SLO(**defaults),
                           build=lambda rng, peer, ep: [])}


def test_ledger_percentiles_and_verdict():
    recs = [_rec("s", t) for t in (10, 20, 30, 40)]
    row = build_ledger(recs, _registry_one(), duration_s=10.0)
    s = row["scenarios"]["s"]
    assert s["ttft_p50_ms"] == 30.0
    assert s["ttft_p95_ms"] == 40.0
    assert s["pass"] and row["verdict"] == "pass"
    # All four completions met the SLO over 10 s.
    assert s["goodput_rps"] == 0.4


def test_ledger_fails_on_ttft_and_queue_lag_counts():
    # 300 ms raw TTFT fails the 200 ms p95... and so does 150 ms raw
    # with 100 ms of worker-pool lag: the open-loop driver charges queue
    # stalls to the SLO, never hides them.
    row = build_ledger([_rec("s", 300.0)], _registry_one(),
                       duration_s=1.0)
    assert row["verdict"] == "fail"
    assert any("ttft_p95" in v for v in row["scenarios"]["s"]["violations"])
    row2 = build_ledger([_rec("s", 150.0, lag=100.0)], _registry_one(),
                        duration_s=1.0)
    assert row2["verdict"] == "fail"


def test_ledger_fails_on_shed_fraction_and_itl():
    recs = ([_rec("s", 10.0) for _ in range(4)]
            + [_rec("s", None, status="shed", shed_ms=5.0,
                    retry_after=True) for _ in range(4)])
    row = build_ledger(recs, _registry_one(max_shed_frac=0.4),
                       duration_s=1.0)
    assert row["scenarios"]["s"]["shed_frac"] == 0.5
    assert row["verdict"] == "fail"     # 0.5 > the 0.4 budget
    assert any("shed_frac" in v
               for v in row["scenarios"]["s"]["violations"])
    row = build_ledger(recs, _registry_one(max_shed_frac=0.6),
                       duration_s=1.0)
    assert row["verdict"] == "pass"     # within budget, fast + well-formed
    row = build_ledger([_rec("s", 10.0, itl=[10.0, 80.0, 90.0, 95.0])],
                       _registry_one(), duration_s=1.0)
    assert any("itl_p95" in v
               for v in row["scenarios"]["s"]["violations"])


def test_ledger_fraction_gates_need_min_samples():
    # One pulse-shed out of two arrivals is a coin flip, not a 50% shed
    # rate: below MIN_FRACTION_N the fractions are reported, not judged.
    recs = [_rec("s", 10.0), _rec("s", None, status="shed", shed_ms=5.0,
                                  retry_after=True)]
    row = build_ledger(recs, _registry_one(max_shed_frac=0.25),
                       duration_s=1.0)
    assert row["scenarios"]["s"]["shed_frac"] == 0.5    # still reported
    assert row["verdict"] == "pass"


# -- classification through the stub ----------------------------------------

def _drive(s, ep, mix="short_chat=1", rate=40.0, dur=0.6, seed=5,
           workers=16, timeout=15.0, chaos=None):
    sched = build_schedule(parse_mix(mix), rate_rps=rate, duration_s=dur,
                           seed=seed, n_peers=max(1, len(ep.ui_urls) or 1))
    drv = LoadDriver(ep, REGISTRY, workers=workers, timeout_s=timeout)
    return drv.run(sched, chaos=chaos)


def test_ok_records_have_ttft_and_tokens(stub):
    s = stub(deltas=3)
    recs = _drive(s, _serve_only(s))
    assert recs and all(r.status == "ok" for r in recs)
    assert all(r.ttft_ms is not None and r.tokens == 3 for r in recs)
    assert all(len(r.itl_ms) == 2 for r in recs)


def test_shed_vs_error_classification(stub):
    s = stub(shed_every=3, error_every=4)
    recs = _drive(s, _serve_only(s), rate=50.0, dur=0.8)
    sheds = [r for r in recs if r.status == "shed"]
    errors = [r for r in recs if r.status == "error"]
    assert sheds and errors
    # Sheds carry the contract evidence: Retry-After seen, answered fast.
    assert all(r.retry_after and r.shed_ms is not None for r in sheds)
    assert all(r.shed_ms < 100.0 for r in sheds)
    assert all(r.error_kind == "http" and "500" in r.error
               for r in errors)
    rep = check_contracts(recs)
    assert rep.ok and rep.sheds == len(sheds)
    assert rep.sheds_with_retry_after == len(sheds)


def test_truncated_stream_classification(stub):
    s = stub(truncate_every=1)          # every stream ends without done
    recs = _drive(s, _serve_only(s), rate=30.0, dur=0.5)
    assert recs and all(r.status == "truncated" for r in recs)


def test_empty_stream_classification(stub):
    """A stream that completes CLEANLY with zero deltas (long_ctx at the
    context budget: max_tokens resolves to 0 after the prompt fills the
    window) is its own ``empty`` status — not error, not truncated — so
    it neither trips the bad-fraction gate nor the chaos mixes' strict
    zero-error contract (the old error/stream classification flaked
    exactly those runs)."""
    s = stub(deltas=0)                  # done record, no deltas ever
    recs = _drive(s, _serve_only(s), rate=30.0, dur=0.5)
    assert recs and all(r.status == "empty" for r in recs)
    assert all(r.error_kind == "" for r in recs)
    row = build_ledger(recs, {"short_chat": REGISTRY["short_chat"]},
                       duration_s=0.5)
    s_row = row["scenarios"]["short_chat"]
    assert s_row["empty"] == len(recs)
    assert s_row["error"] == 0 and s_row["truncated"] == 0
    assert row["empty"] == len(recs) and row["bad"] == 0
    assert not any("error+truncated" in v for v in s_row["violations"])


def _multi_model_steps(n):
    ep = Endpoints(serve_url="http://serve")
    return [REGISTRY["multi_model"].build(random.Random(i), 0, ep)[0]
            for i in range(n)]


def test_multi_model_resolves_tags_and_split(monkeypatch):
    """LOADGEN_MODELS names the two SERVE_MODELS tags; each arrival's
    seeded rng picks one at the fixed 3:1 split, and the payload's
    model field always matches the phase tag the ledger judges under
    (model_a = first tag, model_b = second)."""
    monkeypatch.setenv("LOADGEN_MODELS", "tiny, moe")
    steps = _multi_model_steps(400)
    counts = {"model_a": 0, "model_b": 0}
    for s in steps:
        assert s.measured and s.stream
        assert s.payload["model"] == \
            {"model_a": "tiny", "model_b": "moe"}[s.phase]
        counts[s.phase] += 1
    assert counts["model_b"] > 0
    frac = counts["model_a"] / len(steps)
    assert 0.65 < frac < 0.85           # MULTI_MODEL_SPLIT = 0.75


def test_multi_model_degrades_without_models_env(monkeypatch):
    # Unset: no model field at all — the engine's default serves both
    # classes, phases still tag (single-model runs stay judgeable).
    monkeypatch.delenv("LOADGEN_MODELS", raising=False)
    steps = _multi_model_steps(40)
    assert all("model" not in s.payload for s in steps)
    assert {s.phase for s in steps} == {"model_a", "model_b"}
    # One tag: both classes pin it — the split measures one model.
    monkeypatch.setenv("LOADGEN_MODELS", "only")
    steps = _multi_model_steps(40)
    assert all(s.payload["model"] == "only" for s in steps)


def test_multi_model_ledger_judges_per_model_phases(stub, monkeypatch):
    """Driven end-to-end through the stub (which ignores the model
    field, as a single-model front would): the ledger row carries BOTH
    per-model phase judgements, each with its own SLO — the
    heterogeneous-fleet attribution the scenario exists for."""
    monkeypatch.setenv("LOADGEN_MODELS", "tiny,moe")
    s = stub(deltas=2)
    recs = _drive(s, _serve_only(s), mix="multi_model=1", rate=60.0,
                  dur=0.8)
    assert recs and all(r.status == "ok" for r in recs)
    assert all(set(r.phase_ttft_ms) <= {"model_a", "model_b"}
               and len(r.phase_ttft_ms) == 1 for r in recs)
    row = build_ledger(recs, {"multi_model": REGISTRY["multi_model"]},
                       duration_s=0.8)
    phases = row["scenarios"]["multi_model"]["phases"]
    assert set(phases) == {"model_a", "model_b"}
    assert phases["model_a"]["n"] + phases["model_b"]["n"] == \
        sum(1 for r in recs if r.status == "ok")
    assert phases["model_a"]["n"] > phases["model_b"]["n"] > 0
    # Each class judged against ITS OWN budget, not a blend.
    assert phases["model_b"]["slo"]["ttft_p95_ms"] > \
        phases["model_a"]["slo"]["ttft_p95_ms"]


def test_open_loop_arrivals_fire_on_schedule_despite_stall(stub):
    # Server stalls 400 ms before the first delta. A closed-loop
    # generator would slow its arrival stream to the completion rate;
    # the open-loop driver must keep firing on schedule — the stall
    # shows up ONLY as inflated TTFT.
    s = stub(stall_s=0.4, deltas=1)
    ep = _serve_only(s)
    rate, dur = 25.0, 1.2
    sched = build_schedule(parse_mix("short_chat=1"), rate_rps=rate,
                           duration_s=dur, seed=11, n_peers=1)
    drv = LoadDriver(ep, REGISTRY, workers=64, timeout_s=15.0)
    t0 = time.monotonic()
    recs = drv.run(sched)
    assert len(recs) == len(sched)
    # Arrival-side evidence: every request REACHED the server roughly at
    # its scheduled offset, though each takes ~400 ms to answer. Copy
    # under the stub's lock: request_times is guarded-by _mu, enforced
    # for test readers too under GRAFTCHECK_LOCKCHECK=1.
    lags = []
    with s._mu:
        times = list(s.request_times)
    base = times[0] - sched[0].t                # align clocks
    for arr, seen in zip(sched, sorted(times)):
        lags.append(abs((seen - base) - arr.t))
    assert max(lags) < 0.25, f"arrivals drifted: max {max(lags):.3f}s"
    # Latency-side evidence: the stall is in the judged TTFT.
    ttfts = sorted(r.slo_ttft_ms() for r in recs if r.status == "ok")
    assert ttfts and ttfts[len(ttfts) // 2] >= 380.0
    del t0


def test_bounded_worker_pool_surfaces_stall_as_lag(stub):
    # One worker, stalled server: later arrivals queue behind the stall
    # and the wait lands in lag_ms (charged to the SLO) — the schedule
    # itself still fired on time (previous test); nothing is dropped.
    s = stub(stall_s=0.3, deltas=1)
    sched = build_schedule(parse_mix("short_chat=1"), rate_rps=20.0,
                           duration_s=0.5, seed=2, n_peers=1)
    drv = LoadDriver(_serve_only(s), REGISTRY, workers=1, timeout_s=15.0)
    recs = drv.run(sched)
    assert len(recs) == len(sched) >= 3
    assert max(r.lag_ms for r in recs) > 250.0


# -- chaos -------------------------------------------------------------------

def test_chaos_window_arms_and_disarms():
    failpoints.disarm_all()
    w = ChaosWindow("serve.api.parse=error:boom", arm_at_s=0.0,
                    disarm_at_s=0.25)
    w.start(time.monotonic())
    try:
        deadline = time.monotonic() + 2.0
        while ("serve.api.parse" not in failpoints.armed_sites()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert "serve.api.parse" in failpoints.armed_sites()
        deadline = time.monotonic() + 2.0
        while ("serve.api.parse" in failpoints.armed_sites()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert "serve.api.parse" not in failpoints.armed_sites()
    finally:
        w.stop()
        failpoints.disarm_all()


def test_chaos_contract_checks_flag_violations():
    slow_shed = _rec("s", None, status="shed", shed_ms=250.0,
                     retry_after=True)
    no_retry = _rec("s", None, status="shed", shed_ms=5.0,
                    retry_after=False)
    hung = _rec("s", None, status="error", error_kind="timeout")
    late_fail = TraceRecord(scenario="s", peer=0, sched_s=9.0,
                            status="error", error_kind="http")
    rep = check_contracts([slow_shed, no_retry, hung, late_fail],
                          disarm_at_s=5.0, recovery_grace_s=2.0)
    assert not rep.ok
    text = " ".join(rep.violations)
    assert "Retry-After" in text
    assert "slowest shed" in text
    assert "hung stream" in text
    assert "no recovery" in text
    good = [_rec("s", 10.0),
            _rec("s", None, status="shed", shed_ms=4.0, retry_after=True)]
    assert check_contracts(good, disarm_at_s=5.0).ok


# -- durable rows ------------------------------------------------------------

def test_write_row_uses_first_free_slot(tmp_path):
    p1 = write_row({"metric": "loadgen_e2e", "verdict": "pass"},
                   str(tmp_path))
    p2 = write_row({"metric": "loadgen_e2e", "verdict": "fail"},
                   str(tmp_path))
    assert os.path.basename(p1) == "E2E_r01.json"
    assert os.path.basename(p2) == "E2E_r02.json"
    with open(p1) as f:
        assert json.load(f)["verdict"] == "pass"
    err = error_row(RuntimeError("boom"), {"peers": 4})
    assert err["verdict"] == "error" and "boom" in err["error"]
    assert err["peers"] == 4


# -- the real thing in miniature (slow) -------------------------------------

@pytest.mark.slow
def test_e2e_small_stack_with_chaos(tmp_path):
    """4-peer full stack (directory + the port's tiny engine on the CPU
    over a quote checkpoint + nodes + UIs) through the twin CLI,
    failpoints armed at low probability: a durable E2E row lands with a
    computed verdict and the chaos contracts held."""
    env = dict(os.environ, SERVE_DEVICE="cpu", OMP_NUM_THREADS="2")
    env.pop("FAIL_POINTS", None)
    env.pop("E2E_CKPT_DIR", None)
    r = subprocess.run(
        [sys.executable, "-m", "p2p_llm_chat_tpu_torch.tools.e2e_bench",
         "--peers", "4", "--backend", "torch", "--config", "tiny",
         "--rate", "3", "--duration", "10", "--seed", "1",
         "--boot-wave", "4", "--workers", "16",
         "--node-base", "13811", "--ui-base", "13851",
         "--dir-port", "13801", "--serve-port", "13802",
         "--chaos", "serve.api.stream=drop@0.03,p2p.dht.rpc=drop@0.05",
         "--out-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, timeout=900)
    tail = (r.stdout[-2000:], r.stderr[-2000:])
    assert r.returncode in (0, 1), tail
    rows = sorted(tmp_path.glob("E2E_r0*.json"))
    assert rows, f"no durable row written: {tail}"
    with open(rows[0]) as f:
        row = json.load(f)
    assert row["verdict"] in ("pass", "fail"), row
    assert row.get("arrivals", 0) > 10, (row, tail)
    assert row["chaos"] is not None
    # The degradation contracts hold under armed chaos regardless of
    # whether the SLO verdict passed on this host.
    assert row["chaos"]["ok"], row["chaos"]
    assert row["post_run_probe_ok"] is True, (row, tail)
    per = row["scenarios"]
    assert set(per) == set(REGISTRY)
    ran = [s for s in per.values() if s["n"]]
    assert ran and all(s["ttft_p50_ms"] is not None or s["ok"] == 0
                       for s in ran)
    ck = row["boot"]["quote_ckpt"]
    assert ck["cached"] is False and ck["device"] == "cpu", ck
    assert row["boot"]["serve_ready_s"] > 0, row["boot"]


# -- churn + adversarial clients --------------------------------------------

def test_churn_window_drains_fleet_under_traffic():
    """The churn scenario's run-level half: a ChurnWindow drains and
    undrains a replica mid-run while churn traffic flows through the
    router. Contract: zero session loss on the router ledger, no
    client-visible errors (only ok / well-formed sheds), and the fleet
    is whole again afterwards. FakeLLM replicas have no session tier —
    this is the hookless drain path (migration no-ops gracefully)."""
    from p2p_llm_chat_tpu_torch.loadgen import ChurnWindow
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
    from p2p_llm_chat_tpu_torch.serve.router import (ReplicaRouter,
                                                     parse_metrics_text)
    import urllib.request

    reps = [OllamaServer(FakeLLM(name="rep"), addr="127.0.0.1:0").start()
            for _ in range(2)]
    rt = ReplicaRouter([r.url for r in reps], addr="127.0.0.1:0",
                       scrape_ms=50).start()
    rt.drain_wait_s = 2.0
    try:
        sched = build_schedule(parse_mix("churn=1"), rate_rps=6.0,
                               duration_s=1.6, seed=3, n_peers=4)
        drv = LoadDriver(Endpoints(serve_url=rt.url), REGISTRY,
                         workers=16, timeout_s=20.0)
        churn = ChurnWindow(router_url=rt.url, replica=0,
                            drain_at_s=0.4, undrain_at_s=1.2)
        recs = drv.run(sched, chaos=churn)
        assert recs
        assert churn.churned
        bad = [r for r in recs if r.status in ("error", "truncated")]
        assert not bad, [(r.error_kind, r.error) for r in bad]
        rep = check_contracts(recs)
        assert rep.ok, rep.violations
        with urllib.request.urlopen(f"{rt.url}/metrics", timeout=5) as r:
            snap = parse_metrics_text(r.read().decode())
        assert snap.get("kv_sessions_lost_total", 0) == 0.0
        # The window restored the fleet: nobody is left draining.
        with urllib.request.urlopen(f"{rt.url}/admin/replicas",
                                    timeout=5) as r:
            replicas = json.loads(r.read())["replicas"]
        assert all(not rp["draining"] for rp in replicas), replicas
    finally:
        rt.stop()
        for r in reps:
            r.stop()


def test_slow_reader_and_disconnect_storm_settle_inflight():
    """The slow_reader scenario against a REAL serve front: near-zero
    read rate holds streams open, ~half the arrivals disconnect
    mid-stream — afterwards the front's serve_inflight_requests gauge
    must settle to 0 (the PR 10 stream-close discipline, now
    contract-checked under load)."""
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
    import urllib.request

    srv = OllamaServer(FakeLLM(name="rep", token_delay_s=0.02),
                       addr="127.0.0.1:0").start()
    try:
        sched = build_schedule(parse_mix("slow_reader=1"), rate_rps=25.0,
                               duration_s=0.8, seed=9, n_peers=4)
        drv = LoadDriver(Endpoints(serve_url=srv.url), REGISTRY,
                         workers=32, timeout_s=20.0)
        recs = drv.run(sched)
        assert len(recs) == len(sched) >= 10
        assert all(r.status == "ok" for r in recs), \
            [(r.status, r.error) for r in recs if r.status != "ok"]
        # Both client classes actually occurred (the rng coin): kept
        # streams read to completion, aborters hung up after delta 1.
        aborted = [r for r in recs if r.tokens == 1]
        kept = [r for r in recs if r.tokens > 1]
        assert aborted and kept, (len(aborted), len(kept))
        # The server-side contract: every stream slot released — the
        # inflight gauge settles to 0 despite the disconnect storm.
        deadline = time.monotonic() + 10.0
        inflight = None
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"{srv.url}/metrics",
                                        timeout=5) as r:
                text = r.read().decode()
            inflight = next(
                float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("serve_inflight_requests "))
            if inflight == 0.0:
                break
            time.sleep(0.1)
        assert inflight == 0.0, f"inflight never settled: {inflight}"
    finally:
        srv.stop()


# -- the port against the reference, on the same inputs ---------------------

def _fields(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_equals_reference(seed):
    from p2p_llm_chat_tpu.loadgen import build_schedule as ref_schedule
    from p2p_llm_chat_tpu.loadgen import parse_mix as ref_mix
    for spec in ("", "short_chat=3,embed=1,churn=2"):
        got = build_schedule(parse_mix(spec), rate_rps=8.0, duration_s=20.0,
                             seed=seed, n_peers=32)
        want = ref_schedule(ref_mix(spec), rate_rps=8.0, duration_s=20.0,
                            seed=seed, n_peers=32)
        assert len(got) > 100
        assert [_fields(a) for a in got] == [_fields(a) for a in want]


def test_parse_mix_percentile_and_contracts_equal_reference():
    from p2p_llm_chat_tpu.loadgen import check_contracts as ref_contracts
    from p2p_llm_chat_tpu.loadgen import parse_mix as ref_mix
    from p2p_llm_chat_tpu.loadgen import percentile as ref_percentile
    from p2p_llm_chat_tpu.loadgen import TraceRecord as RefRecord
    for spec in ("", "short_chat=3,embed=1", "park_wake,churn=0.25"):
        assert [(s.name, w) for s, w in parse_mix(spec)] == \
            [(s.name, w) for s, w in ref_mix(spec)]
    for bad in ("no_such=1", "embed=0", ",,"):
        with pytest.raises(ValueError) as a:
            parse_mix(bad)
        with pytest.raises(ValueError) as b:
            ref_mix(bad)
        assert str(a.value) == str(b.value)
    rng = random.Random(3)
    xs = [rng.uniform(0, 500) for _ in range(37)]
    for n in (0, 1, 2, 5, 37):
        for p in (0, 50, 95, 99, 100):
            assert percentile(xs[:n], p) == ref_percentile(xs[:n], p)
    kw = [dict(status="shed", shed_ms=250.0, retry_after=True),
          dict(status="shed", shed_ms=5.0, retry_after=False),
          dict(status="error", error_kind="timeout"),
          dict(status="error", error_kind="http", sched_s=9.0),
          dict(status="ok", ttft_ms=10.0),
          dict(status="truncated", sched_s=1.0)]
    for recs in (kw, kw[4:5], kw[:2]):
        for disarm in (None, 5.0):
            got = check_contracts(
                [TraceRecord(scenario="s", peer=0,
                             **{"sched_s": 0.0, **k}) for k in recs],
                disarm_at_s=disarm)
            want = ref_contracts(
                [RefRecord(scenario="s", peer=0,
                           **{"sched_s": 0.0, **k}) for k in recs],
                disarm_at_s=disarm)
            assert got.to_dict() == want.to_dict()


def _synthetic(cls, n=300, seed=4):
    """The same synthetic trace records of every registered scenario, as
    ``cls`` (either package's TraceRecord): every status, phases on the
    phase-tagged scenarios, lag, trace ids."""
    rng = random.Random(seed)
    names = list(REGISTRY)
    out = []
    for i in range(n):
        name = names[i % len(names)]
        status = rng.choice(("ok",) * 6 + ("shed", "error", "truncated",
                                           "empty"))
        ttft = rng.uniform(5, 9000) if status == "ok" else None
        rec = cls(scenario=name, peer=rng.randrange(32),
                  sched_s=rng.uniform(0, 20), lag_ms=rng.uniform(0, 300),
                  status=status, ttft_ms=ttft,
                  itl_ms=[rng.uniform(1, 3000) for _ in range(rng.randrange(5))],
                  tokens=rng.randrange(30),
                  retry_after=status == "shed",
                  shed_ms=rng.uniform(1, 150) if status == "shed" else None,
                  error_kind=("http" if status == "error" else ""),
                  trace_id=f"{i:032x}")
        if status == "ok" and REGISTRY[name].phase_slos:
            for ph in REGISTRY[name].phase_slos:
                rec.phase_ttft_ms[ph] = rng.uniform(5, 25000)
                rec.phase_itl_ms[ph] = [rng.uniform(1, 4000)]
        out.append(rec)
    return out


def test_build_ledger_equals_reference():
    from p2p_llm_chat_tpu.loadgen import REGISTRY as REF_REGISTRY
    from p2p_llm_chat_tpu.loadgen import TraceRecord as RefRecord
    from p2p_llm_chat_tpu.loadgen import build_ledger as ref_ledger
    from p2p_llm_chat_tpu.loadgen import check_contracts as ref_contracts
    spans = {f"{i:032x}": [{"name": "sched.prefill", "dur_ms": i % 7},
                           {"name": "sched.decode", "dur_ms": i % 5},
                           {"name": "api.request", "dur_ms": 1e4}]
             for i in range(0, 300, 3)}
    got_recs, want_recs = _synthetic(TraceRecord), _synthetic(RefRecord)
    got = build_ledger(got_recs, REGISTRY, duration_s=20.0,
                       meta={"peers": 32},
                       contract=check_contracts(got_recs, disarm_at_s=10.0),
                       timelines=spans)
    want = ref_ledger(want_recs, REF_REGISTRY, duration_s=20.0,
                      meta={"peers": 32},
                      contract=ref_contracts(want_recs, disarm_at_s=10.0),
                      timelines=spans)
    got.pop("recorded_at")
    want.pop("recorded_at")
    assert got == want
    assert got["verdict"] == "fail" and got["arrivals"] == 300


def test_registry_equals_reference_field_by_field():
    from p2p_llm_chat_tpu.loadgen import REGISTRY as REF_REGISTRY
    from p2p_llm_chat_tpu.loadgen import Endpoints as RefEndpoints
    assert list(REGISTRY) == list(REF_REGISTRY)
    eps = [(Endpoints(serve_url="http://s"), RefEndpoints(serve_url="http://s"))]
    urls = tuple(f"http://n{i}" for i in range(5))
    uis = tuple(f"http://u{i}" for i in range(5))
    users = tuple(f"peer{i:02d}" for i in range(5))
    eps.append((Endpoints("http://s", uis, urls, users),
                RefEndpoints("http://s", uis, urls, users)))
    for name, s in REGISTRY.items():
        r = REF_REGISTRY[name]
        assert (s.name, s.weight) == (r.name, r.weight)
        assert _fields(s.slo) == _fields(r.slo)
        assert (s.phase_slos is None) == (r.phase_slos is None)
        if s.phase_slos:
            assert {k: _fields(v) for k, v in s.phase_slos.items()} == \
                {k: _fields(v) for k, v in r.phase_slos.items()}
        for ep, rep in eps:
            for seed in range(6):
                for peer in (0, 3):
                    got = s.build(random.Random(seed), peer, ep)
                    want = r.build(random.Random(seed), peer, rep)
                    assert [_fields(x) for x in got] == \
                        [_fields(x) for x in want], (name, seed, peer)


def _front_run(url, mix, seed, n_peers=4, rate=20.0, dur=1.0):
    sched = build_schedule(parse_mix(mix), rate_rps=rate, duration_s=dur,
                           seed=seed, n_peers=n_peers)
    drv = LoadDriver(Endpoints(serve_url=url), REGISTRY, workers=32,
                     timeout_s=20.0)
    return sched, drv.run(sched)


SERVE_MIX = "short_chat=2,embed=1,unbounded=1,park_wake=1,group_chat=1"


def test_driver_against_the_ports_front():
    """A seeded mix of serve-level scenarios against the port's
    ``OllamaServer(FakeLLM)``: every arrival completes ok with tokens, the
    embed's whole answer is its TTFT, and the row passes."""
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
    srv = OllamaServer(FakeLLM(name="rep", token_delay_s=0.002),
                       addr="127.0.0.1:0").start()
    try:
        sched, recs = _front_run(srv.url, SERVE_MIX, seed=0)
        assert len(recs) == len(sched) >= 10
        bad = [(r.scenario, r.status, r.error) for r in recs
               if r.status != "ok"]
        assert not bad, bad
        assert {r.scenario for r in recs} >= {"short_chat", "embed"}
        for r in recs:
            assert r.ttft_ms is not None and r.ttft_ms > 0
            assert r.tokens > 0 or r.scenario == "embed"
        row = build_ledger(recs, REGISTRY, duration_s=1.0)
        assert row["verdict"] == "pass", row["failures"]
        assert row["ok"] == len(recs)
    finally:
        srv.stop()


def test_driver_against_the_ports_router():
    """The same mix through the port's ``ReplicaRouter`` over two
    ``OllamaServer(FakeLLM)`` fronts: every arrival ok, both replicas
    served, and the breach-attribution lookup reads the router's merged
    ``/admin/trace``."""
    from p2p_llm_chat_tpu_torch.loadgen import fetch_timelines
    from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
    from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM
    from p2p_llm_chat_tpu_torch.serve.router import ReplicaRouter
    import urllib.request
    reps = [OllamaServer(FakeLLM(name="rep", token_delay_s=0.002),
                         addr="127.0.0.1:0").start() for _ in range(2)]
    rt = ReplicaRouter([r.url for r in reps], addr="127.0.0.1:0",
                       scrape_ms=50).start()
    try:
        sched, recs = _front_run(rt.url, SERVE_MIX, seed=1, rate=30.0)
        assert len(recs) == len(sched) >= 10
        bad = [(r.scenario, r.status, r.error) for r in recs
               if r.status != "ok"]
        assert not bad, bad
        with urllib.request.urlopen(f"{rt.url}/admin/replicas",
                                    timeout=5) as r:
            routed = [rp["routed"] for rp in json.loads(r.read())["replicas"]]
        assert len(routed) == 2 and all(n > 0 for n in routed), routed
        lookup = fetch_timelines(rt.url)
        assert lookup("") is None
        spans = lookup(recs[0].trace_id)
        assert spans is None or isinstance(spans, list)
        row = build_ledger(recs, REGISTRY, duration_s=1.0,
                           timelines=lookup)
        assert row["verdict"] == "pass", row["failures"]
    finally:
        rt.stop()
        for r in reps:
            r.stop()


def test_stub_cli_row_keys_equal_reference(tmp_path):
    """``--stub --duration 3`` of the twin CLI (``python -m
    p2p_llm_chat_tpu_torch.tools.e2e_bench``) beside the reference's
    ``tools/e2e_bench.py``: both pass and print rows with equal keys."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("FAIL_POINTS", None)
    rows = []
    for cmd in ([sys.executable, "-m",
                 "p2p_llm_chat_tpu_torch.tools.e2e_bench"],
                [sys.executable, os.path.join(ROOT, "tools",
                                              "e2e_bench.py")]):
        r = subprocess.run(cmd + ["--stub", "--duration", "3"], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
    got, want = rows
    assert got["verdict"] == want["verdict"] == "pass"
    assert sorted(got) == sorted(want)
    assert sorted(got["scenarios"]) == sorted(want["scenarios"])
    assert got["stub"] is True and got["arrivals"] > 10


def test_quote_checkpoint_cache_rebuilds_a_reference_dir(tmp_path,
                                                         monkeypatch):
    """``E2E_CKPT_DIR`` holding the reference's native checkpoint (its
    ``native_meta.json`` and Orbax ``params/``, which the port refuses) is
    cleared and rebuilt as an HF directory under the port's own marker;
    the next run reuses it; a directory of another config is rebuilt."""
    from p2p_llm_chat_tpu_torch.models.weights import (is_native_checkpoint,
                                                       load_checkpoint)
    from p2p_llm_chat_tpu_torch.tools import e2e_bench
    d = tmp_path / "cache"
    (d / "params").mkdir(parents=True)
    (d / "params" / "x").write_text("orbax")
    (d / "native_meta.json").write_text(json.dumps({"config": "tiny"}))
    (d / "keep.txt").write_text("not the bench's")
    monkeypatch.setenv("E2E_CKPT_DIR", str(d))
    env = dict(os.environ, SERVE_DEVICE="cpu", OMP_NUM_THREADS="1")
    st = e2e_bench.build_quote_checkpoint("tiny", env)
    assert st["cached"] is False and st["temporary"] is False
    assert st["device"] == "cpu" and st["bytes"] > 0
    assert env["CKPT_DIR"] == str(d) and env["LLM_MODEL"] == "tiny"
    assert not is_native_checkpoint(str(d))
    assert not (d / "params").exists() and (d / "keep.txt").exists()
    with open(d / e2e_bench.QUOTE_MARKER) as f:
        assert json.load(f)["config"] == "tiny"
    params, cfg = load_checkpoint(str(d), device="cpu")
    assert cfg.name == "tiny" and "lm_head" in params
    env2 = dict(os.environ, SERVE_DEVICE="cpu")
    assert e2e_bench.build_quote_checkpoint("tiny", env2) == {"cached": True}
    assert env2["CKPT_DIR"] == str(d)
    st = e2e_bench.build_quote_checkpoint("tiny-moe",
                                          dict(env, OMP_NUM_THREADS="1"))
    assert st["cached"] is False
    _, cfg = load_checkpoint(str(d), device="cpu")
    assert cfg.num_experts > 0
