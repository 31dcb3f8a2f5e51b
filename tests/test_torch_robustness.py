"""The port's robustness plane against the reference's (utils/failpoints.py,
utils/backoff.py, obs/, the scheduler's watchdog, flight recorder, trace
spans and device-step probe), on the CPU.

- The failpoint grammar, arming, counters and env loading, case for case
  over both packages' modules; the port's ``KNOWN_SITES`` equal to the
  reference's; the retry counter of both ``with_retries``.
- The front's sites (``serve.api.parse`` error/raise, ``serve.api.stream``
  raise/drop) on both fronts over FakeLLM, with
  ``failpoint_hits_total`` on ``/metrics``.
- The port engine's ``serve.scheduler.admit``, ``.dispatch``,
  ``serve.engine.readback`` and ``.promote`` faults: the faulted request
  fails with the reference's message and the next greedy request gives
  the text it gave before the fault (the reference's
  tests/test_failpoints.py:297-345); a failed promotion build leaves
  serving untouched.
- The loop watchdog's gauge at a tiny ``loop_budget_ms``, and a stall
  dump whose ``stall_enter`` shares its iteration with a ``dispatch``
  event (the reference's tests/test_trace.py:481).
- One traced request's spans carry the reference's names and fields.
- ``decode_device_ms`` > 0 after warmup, and a seeded temperature > 0
  stream is unchanged by extra probes, against a fresh engine.
"""

import json
import time
import urllib.request

import pytest
import torch

from p2p_llm_chat_tpu.serve.api import OllamaServer as RefServer
from p2p_llm_chat_tpu.serve.backend import FakeLLM as RefFake
from p2p_llm_chat_tpu.utils import backoff as ref_backoff
from p2p_llm_chat_tpu.utils import failpoints as ref_fp
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.llama import init_params_quantized
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import (FakeLLM, GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.serve.scheduler import _WarmupJob
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils import backoff
from p2p_llm_chat_tpu_torch.utils import failpoints as fp

torch.set_num_threads(2)

CFG = get_config("tiny")
FPS = pytest.mark.parametrize("mod", [ref_fp, fp], ids=["jax", "torch"])


@pytest.fixture(autouse=True)
def _clean_failpoints():
    """Both registries are process-global: nothing armed, and no hit
    these tests count, leaks into another test file of the process."""
    for mod in (ref_fp, fp):
        mod.disarm_all()
        mod.reset_hits()
    yield
    for mod in (ref_fp, fp):
        mod.disarm_all()
        mod.reset_hits()


# -- registry / grammar, over both modules -----------------------------------

@FPS
def test_disarmed_site_is_noop_and_uncounted(mod):
    assert mod.failpoint("serve.api.parse") is None
    assert mod.hits("serve.api.parse") == 0


@FPS
def test_arm_raise_count_and_self_disarm(mod):
    mod.arm("t.raise", "raise:boom")
    with pytest.raises(mod.FailpointError, match="boom"):
        mod.failpoint("t.raise")
    assert mod.hits("t.raise") == 1
    mod.disarm("t.raise")
    assert mod.failpoint("t.raise") is None
    mod.arm("t.count", "raise*2")
    for _ in range(2):
        with pytest.raises(mod.FailpointError):
            mod.failpoint("t.count")
    assert mod.failpoint("t.count") is None
    assert mod.hits("t.count") == 2


@FPS
def test_delay_drop_error_prob_kinds(mod):
    mod.arm("t.delay", "delay:30")
    t0 = time.monotonic()
    act = mod.failpoint("t.delay")
    assert act is not None and act.kind == "delay"
    assert time.monotonic() - t0 >= 0.025
    mod.arm("t.drop", "drop")
    assert mod.failpoint("t.drop").kind == "drop"
    mod.arm("t.err", "error:nope")
    act = mod.failpoint("t.err")
    assert act.kind == "error" and act.msg == "nope"
    mod.arm("t.never", "raise@0")
    assert mod.failpoint("t.never") is None
    assert mod.hits("t.never") == 0


@FPS
@pytest.mark.parametrize("bad", ["explode", "raise*0", "raise@2", "delay",
                                 "delay:x"])
def test_grammar_rejects_malformed_specs(mod, bad):
    with pytest.raises(ValueError):
        mod.parse_spec(bad)


@FPS
def test_env_arming_is_all_or_nothing(mod, monkeypatch):
    monkeypatch.setenv("FAIL_POINTS", "t.env=raise*1, t.env2=drop")
    mod.load_env(force=True)
    assert {"t.env", "t.env2"} <= set(mod.armed_sites())
    with pytest.raises(mod.FailpointError):
        mod.failpoint("t.env")
    mod.disarm_all()
    monkeypatch.setenv("FAIL_POINTS", "t.ok=drop,not-an-entry")
    with pytest.raises(ValueError):
        mod.load_env(force=True)
    assert mod.armed_sites() == ()
    monkeypatch.delenv("FAIL_POINTS")
    mod.load_env(force=True)


def test_known_sites_equal_the_reference():
    assert fp.KNOWN_SITES == ref_fp.KNOWN_SITES


@pytest.mark.parametrize("mod", [ref_backoff, backoff], ids=["jax", "torch"])
def test_with_retries_recovers_and_counts(mod):
    before = mod.retries_total()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "ok"

    assert mod.with_retries(flaky, attempts=3, base_s=0.01,
                            max_s=0.02) == "ok"
    assert mod.retries_total() - before == 2


def test_malformed_fail_points_fail_the_front_at_construction(monkeypatch):
    monkeypatch.setenv("FAIL_POINTS", "serve.api.parse")
    with pytest.raises(ValueError):
        fp.load_env(force=True)
    monkeypatch.setattr(fp, "_env_loaded", False)
    with pytest.raises(ValueError):
        OllamaServer(FakeLLM(), addr="127.0.0.1:0")
    monkeypatch.delenv("FAIL_POINTS")
    fp.load_env(force=True)


# -- the front's sites, on both fronts over FakeLLM ---------------------------

FRONTS = pytest.mark.parametrize("front", [(RefServer, RefFake, ref_fp),
                                           (OllamaServer, FakeLLM, fp)],
                                 ids=["jax", "torch"])


def _post(url: str, body: dict, headers=None) -> tuple[int, list]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            status, text = e.code, e.read().decode()
    return status, [json.loads(x) for x in text.splitlines() if x.strip()]


@FRONTS
def test_api_sites_answer_well_formed(front):
    server_cls, fake_cls, mod = front
    srv = server_cls(fake_cls(), addr="127.0.0.1:0").start()
    url = srv.url + "/api/generate"
    try:
        mod.arm("serve.api.parse", "error:injected parse fault")
        status, recs = _post(url, {"prompt": "x", "stream": False})
        assert status == 500 and "injected parse fault" in recs[0]["error"]
        mod.arm("serve.api.parse", "raise*1")
        status, recs = _post(url, {"prompt": "x", "stream": False})
        assert status == 500 and "error" in recs[0]
        assert _post(url, {"prompt": "hi", "stream": False})[0] == 200
        mod.arm("serve.api.stream", "raise*1")
        status, recs = _post(url, {"prompt": "hello"})
        assert recs[-1]["done"] is True and "error" in recs[-1]
        mod.arm("serve.api.stream", "drop*1")
        status, recs = _post(url, {"prompt": "hello there"})
        assert recs[-1]["done"] is True and "error" not in recs[-1]
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'failpoint_hits_total{site="serve.api.parse"} 2' in text
        assert 'failpoint_hits_total{site="serve.api.stream"} 2' in text
        assert "retry_attempts_total" in text
    finally:
        mod.reset_hits()
        srv.stop()


# -- the engine's sites ---------------------------------------------------------

def _engine(**kw) -> TorchEngine:
    params = init_params_quantized(CFG, seed=0, quant="int8", device="cpu")
    return TorchEngine(params, CFG, ByteTokenizer(CFG.vocab_size),
                       num_slots=3, max_seq=128, page_size=16, kv_quant=True,
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def engine():
    eng = _engine()
    yield eng
    eng.stop()


def run(engine, prompt, max_tokens=8, **opts) -> str:
    req = GenerateRequest(prompt=prompt, options=GenerateOptions(
        max_tokens=max_tokens, **opts))
    return "".join(engine.generate_stream(req, RequestStats()))


def _on_loop(sched, fn=lambda: None):
    job = _WarmupJob(fn)
    sched._admit_q.put(job)
    job.done.wait()
    if job.err is not None:
        raise job.err


def _quiesce(engine) -> None:
    """Return once the loop has read back the pipelined tick the last
    request left behind (a job runs before its iteration's idle
    read-back; the second job runs after it), so an armed site fires on
    the next request's ticks."""
    _on_loop(engine.scheduler)
    _on_loop(engine.scheduler)


@pytest.mark.parametrize("site,match", [
    ("serve.scheduler.admit", "admission failed"),
    ("serve.scheduler.dispatch", "reset"),
    ("serve.engine.readback", "reset"),
])
def test_engine_site_fails_the_request_then_recovers(engine, site, match):
    prompt = f"after the {site} fault"
    want = run(engine, prompt)
    _quiesce(engine)
    fp.reset_hits()
    fp.arm(site, "raise*1")
    with pytest.raises(RuntimeError, match=match):
        run(engine, "fault me")
    assert fp.hits(site) == 1
    assert run(engine, prompt) == want
    _quiesce(engine)                    # the finished row is released
    snap = engine.metrics_snapshot()
    assert snap["serve_kv_free_pages"] == snap["serve_kv_total_pages"]


def test_promotion_fault_drops_the_build_serving_unaffected(engine):
    fp.arm("serve.scheduler.promote", "raise")
    long_prompt = ("p" * 70) + " tail"
    a = run(engine, long_prompt, max_tokens=4)
    b = run(engine, long_prompt, max_tokens=4)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not fp.hits(
            "serve.scheduler.promote"):
        time.sleep(0.02)
    assert fp.hits("serve.scheduler.promote") >= 1
    assert a == b == run(engine, long_prompt, max_tokens=4)
    fp.disarm("serve.scheduler.promote")


def test_watchdog_exports_the_loop_stall_gauge(engine):
    sched = engine.scheduler
    saved = sched.loop_budget_ms
    try:
        sched.loop_budget_ms = 0.001        # every iteration over budget
        run(engine, "stall probe", max_tokens=4)
        deadline = time.monotonic() + 5.0
        while (time.monotonic() < deadline
               and sched.metrics_snapshot()["loop_stall_ms"] == 0):
            time.sleep(0.02)
        snap = sched.metrics_snapshot()
        assert snap["loop_stall_ms"] > 0 and snap["loop_stall_last_ms"] > 0
    finally:
        sched.loop_budget_ms = saved


def test_stall_dump_names_the_dispatch_iteration(engine, tmp_path):
    sched = engine.scheduler
    saved_budget, saved_path = sched.loop_budget_ms, sched._flight.path
    deadline = time.monotonic() + 5.0
    while sched._loop_stalled and time.monotonic() < deadline:
        time.sleep(0.02)                    # an earlier episode recovers
    path = str(tmp_path / "flight.json")
    sched._flight.path = path
    dumps = sched.metrics_snapshot()["serve_flight_dumps_total"]
    try:
        sched.loop_budget_ms = 50.0
        fp.arm("serve.scheduler.dispatch", "delay:250")
        run(engine, "stall probe", max_tokens=4, seed=1)
        snap = sched.metrics_snapshot()
        assert snap["serve_flight_dumps_total"] > dumps
        assert snap["loop_stall_ms"] >= 50.0
        assert snap["loop_stall_last_ms"] >= 50.0
        with open(path) as fh:
            doc = json.load(fh)
        assert doc["reason"] == "watchdog_stall"
        # This episode's marker is the ring's last (the dump is written
        # at episode entry); earlier tests' episodes sit before it.
        stall = [ev for ev in doc["events"]
                 if ev["kind"] == "stall_enter"][-1]
        assert stall["over_ms"] >= 50.0
        assert any(ev["kind"] == "dispatch" and ev["it"] == stall["it"]
                   for ev in doc["events"])
    finally:
        fp.disarm_all()
        sched.loop_budget_ms = saved_budget
        sched._flight.path = saved_path


def test_trace_spans_carry_the_reference_names(engine):
    srv = OllamaServer(engine, addr="127.0.0.1:0").start()
    tid = "ab" * 16
    try:
        status, recs = _post(srv.url + "/api/generate",
                             {"prompt": "trace me", "stream": False,
                              "options": {"num_predict": 4}},
                             headers={"X-Graft-Trace": f"{tid};s=1"})
        assert status == 200
        with urllib.request.urlopen(f"{srv.url}/admin/trace?id={tid}",
                                    timeout=10) as r:
            spans = json.loads(r.read())["spans"]
        meta = {sp["name"]: set(sp.get("meta", {})) for sp in spans}
        assert meta == {"api.request": {"endpoint", "tokens"},
                        "sched.queue_wait": set(),
                        "sched.prefill": {"tokens", "row"},
                        "sched.decode": {"tokens", "row"}}
        assert all(sp["replica"] == srv.url.split("://", 1)[1]
                   for sp in spans)
        req = urllib.request.Request(srv.url + "/admin/trace/dump",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["status"] == "dumped"
        with open(doc["path"]) as fh:
            assert json.load(fh)["reason"] == "on_demand"
    finally:
        srv.stop()


def test_probe_reads_a_device_step_and_moves_no_seeded_stream():
    """Three extra probes run on the loop while a seeded sampled stream
    is live (its row parked for them): the stream equals a fresh
    engine's."""
    opts = GenerateOptions(max_tokens=24, temperature=0.9, top_p=0.95,
                           seed=7)
    fresh, probed = _engine(), _engine()
    try:
        for eng in (fresh, probed):
            eng.warmup((16,))
        deadline = time.monotonic() + 60
        while not (fresh.ready() and probed.ready()):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert fresh.metrics_snapshot()["decode_device_ms"] > 0
        want = "".join(fresh.generate_stream(
            GenerateRequest(prompt="seeded", options=opts)))
        it = probed.generate_stream(GenerateRequest(prompt="seeded",
                                                    options=opts))
        got = next(it)
        for _ in range(3):
            _on_loop(probed.scheduler, probed.scheduler._probe_device_step)
        got += "".join(it)
        assert probed.metrics_snapshot()["decode_device_ms"] > 0
        assert got == want
    finally:
        fresh.stop()
        probed.stop()


@pytest.mark.parametrize("value,budget", [(None, 5000.0), ("0", 0.0),
                                          ("75", 75.0)])
def test_loop_budget_is_read_from_the_env(monkeypatch, value, budget):
    from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env
    for k, v in dict(SERVE_DEVICE="cpu", MODEL_CONFIG="tiny",
                     SERVE_WARMUP="0", SERVE_MAX_SEQ="64",
                     SERVE_SLOTS="1").items():
        monkeypatch.setenv(k, v)
    if value is None:
        monkeypatch.delenv("SERVE_LOOP_BUDGET_MS", raising=False)
    else:
        monkeypatch.setenv("SERVE_LOOP_BUDGET_MS", value)
    eng = build_engine_from_env()
    try:
        assert eng.scheduler.loop_budget_ms == budget
        if not budget:        # 0 disables: no stall is ever booked
            eng.scheduler._watchdog(time.monotonic() - 10.0)
            assert eng.metrics_snapshot()["loop_stall_ms"] == 0
    finally:
        eng.stop()
