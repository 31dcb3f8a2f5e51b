"""Two port engines on the CPU behind the port's router: a prefill-class
and a decode-class replica (tiny config, paged int8 pool, the KV tier and
the prefix cache on, quote weights from the reference's
models/synth.quote_params carried over by models/convert.py).

- A new conversation rides the disaggregated handoff
  (``disagg_handoffs_total`` 1; the source forgets its copy on the ack;
  affinity on the decode replica). Its greedy stream equals the
  reference router's over the same two port fronts, the reference's
  ``drive_handoff`` followed by the request on the decode front, and the
  reference router's over two JAX engines on the same weights.
- The follow-up turn goes to the decode replica by affinity and wakes
  there.
- With ``serve.disagg.handoff`` armed the request finishes on the
  prefill replica: 200, the same stream, one
  ``disagg_handoff_failures_total``.
- A drain of the decode replica through the router migrates its
  sessions; the next turn equals that of a twin session that never
  moved. With ``serve.router.migrate`` armed a drain moves nothing and
  the source keeps every session.
- A prefix promoted on one replica is pulled by the other.

Tolerance: exact, tokens and counters.
"""

import json
import time
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve import disagg as ref_disagg
from p2p_llm_chat_tpu.serve import router as ref_router
from p2p_llm_chat_tpu.serve.api import OllamaServer as RefServer
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve import ReplicaRouter
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.serve.router import parse_metrics_text
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils import failpoints

torch.set_num_threads(2)

PROMPT1 = "hello there, how are you doing today my good friend?"
PROMPT2 = " tell me one more thing before we finish?"
PROMPT3 = " and one last question, then we are done."
SHARED = ("A shared system preamble that every request of this app sends "
          "first, long enough to span two grains of the prefix ladder. ")
ENGINE = dict(num_slots=2, max_seq=256, kv_mode="paged", page_size=64,
              kv_quant=True, kv_host_gb=1.0, kv_idle_s=1e9,
              prefill_chunk=256)


def _post(url: str, body: dict, timeout: float = 120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _gen(url: str, prompt: str, session: str = "", ctx=()) -> dict:
    body = {"model": "tiny", "prompt": prompt, "stream": False,
            "options": {"num_predict": 8, "temperature": 0.0, "seed": 1}}
    if session:
        body["session"] = session
    if ctx:
        body["context"] = list(ctx)
    status, rec = _post(f"{url}/api/generate", body)
    assert status == 200 and rec["done"] is True, rec
    return rec


def _json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _metrics(url: str) -> dict:
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        return parse_metrics_text(r.read().decode())


def _wait(fn, timeout: float = 30.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _wait_classes(router_url: str, want: dict) -> None:
    def ok():
        reps = {r["url"]: r for r in
                _json(f"{router_url}/admin/replicas")["replicas"]}
        return all(u in reps and reps[u]["class"] == c and reps[u]["ready"]
                   for u, c in want.items())
    _wait(ok, what=f"the router's class view {want}")


def _sessions(url: str) -> set:
    return set(_json(f"{url}/admin/session")["sessions"])


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_config("tiny")
    rparams = quote_params(rcfg, jax.random.PRNGKey(5), quantized=True)
    return rparams, params_from_numpy(jax.tree.map(np.asarray, rparams),
                                      device="cpu")


@pytest.fixture(scope="module")
def fleet(weights):
    cfg = get_config("tiny")
    engines = []
    for _ in range(2):
        eng = TorchEngine(weights[1], cfg, ByteTokenizer(cfg.vocab_size),
                          device="cpu", **ENGINE)
        eng.scheduler.warmup((64, 128))
        engines.append(eng)
    fronts = [OllamaServer(e, addr="127.0.0.1:0", replica_class=c).start()
              for e, c in zip(engines, ("prefill", "decode"))]
    rt = ReplicaRouter([f.url for f in fronts], addr="127.0.0.1:0",
                       scrape_ms=100).start()
    try:
        pre, dec = (f.url for f in fronts)
        _wait_classes(rt.url, {pre: "prefill", dec: "decode"})
        yield SimpleNamespace(pre=pre, dec=dec, rt=rt,
                              oracle=_gen(dec, PROMPT1))
    finally:
        rt.stop()
        for f in fronts:
            f.stop()
        for e in engines:
            e.stop()


def _waked(url: str) -> float:
    return _metrics(url)["kv_waked_total"]


def test_handoff_equals_every_reference_path(fleet, weights):
    f = fleet
    wa, wb = _waked(f.pre), _waked(f.dec)
    r1 = _gen(f.rt.url, PROMPT1, "rr")
    assert r1["response"] == f.oracle["response"]
    assert r1["context"] == f.oracle["context"]
    snap = _metrics(f.rt.url)
    assert snap["disagg_handoffs_total"] == 1.0
    assert snap["disagg_handoff_ms_count"] == 1.0
    assert snap.get("disagg_handoff_failures_total", 0) == 0
    with f.rt._mu:
        assert f.rt._sessions["rr"] == 1             # the decode home
    assert "sid:rr" not in _sessions(f.pre)          # forgotten on the ack
    assert "sid:rr" in _sessions(f.dec)
    assert (_waked(f.pre), _waked(f.dec)) == (wa, wb + 1)

    # The follow-up turn: affinity to the decode replica, woken there.
    r2 = _gen(f.rt.url, PROMPT2, "rr", r1["context"])
    assert (_waked(f.pre), _waked(f.dec)) == (wa, wb + 2)
    assert _metrics(f.rt.url)["disagg_handoffs_total"] == 1.0

    # The reference's router over the same two port fronts.
    ref_rt = ref_router.ReplicaRouter([f.pre, f.dec], addr="127.0.0.1:0",
                                      scrape_ms=100).start()
    try:
        _wait_classes(ref_rt.url, {f.pre: "prefill", f.dec: "decode"})
        got = _gen(ref_rt.url, PROMPT1, "rr-ref")
        assert got["context"] == r1["context"]
        assert _metrics(ref_rt.url)["disagg_handoffs_total"] == 1.0
        assert "sid:rr-ref" in _sessions(f.dec)
    finally:
        ref_rt.stop()

    # The reference's drive_handoff, then the request on the decode front.
    body = {"model": "tiny", "prompt": PROMPT1, "stream": False,
            "session": "dh",
            "options": {"num_predict": 8, "temperature": 0.0, "seed": 1}}
    meta = ref_disagg.drive_handoff(f.pre, f.dec, "/api/generate", body,
                                    session="dh")
    assert meta is not None and meta["key"] == "sid:dh"
    got = _gen(f.dec, PROMPT1, "dh")
    assert got["context"] == r1["context"]
    assert _gen(f.dec, PROMPT2, "dh", got["context"])["context"] == \
        r2["context"]

    # The reference's router over two JAX engines on the same weights.
    rcfg = ref_config("tiny")
    jax_engines, jax_fronts = [], []
    try:
        for cls in ("prefill", "decode"):
            eng = TPUEngine(weights[0], rcfg,
                            RefByteTokenizer(rcfg.vocab_size), **ENGINE)
            eng.warmup(buckets=(64, 128))
            jax_engines.append(eng)
            jax_fronts.append(RefServer(eng, addr="127.0.0.1:0",
                                        replica_class=cls).start())
        jrt = ref_router.ReplicaRouter([s.url for s in jax_fronts],
                                       addr="127.0.0.1:0",
                                       scrape_ms=100).start()
        try:
            _wait_classes(jrt.url, {jax_fronts[0].url: "prefill",
                                    jax_fronts[1].url: "decode"})
            got = _gen(jrt.url, PROMPT1, "rr")
            assert got["context"] == r1["context"]
            assert got["response"] == r1["response"]
            assert _metrics(jrt.url)["disagg_handoffs_total"] == 1.0
            assert _gen(jrt.url, PROMPT2, "rr", got["context"])[
                "context"] == r2["context"]
        finally:
            jrt.stop()
    finally:
        for s in jax_fronts:
            s.stop()
        for e in jax_engines:
            e.stop()


def test_failed_handoff_finishes_on_the_prefill_replica(fleet):
    f = fleet
    served = _metrics(f.pre)["serve_requests_total"]
    failpoints.arm("serve.disagg.handoff", "raise")
    try:
        got = _gen(f.rt.url, PROMPT1, "deg")
    finally:
        failpoints.disarm_all()
    assert got["context"] == f.oracle["context"]
    snap = _metrics(f.rt.url)
    assert snap["disagg_handoff_failures_total"] == 1.0
    assert snap.get("kv_sessions_lost_total", 0) == 0
    assert _metrics(f.pre)["serve_requests_total"] == served + 1
    with f.rt._mu:
        assert f.rt._sessions["deg"] == 0


def test_drain_migrates_and_the_next_turn_equals_the_unmoved_twin(fleet):
    f = fleet
    m1 = _gen(f.rt.url, PROMPT1, "mv")
    m2 = _gen(f.rt.url, PROMPT2, "mv", m1["context"])
    t1 = _gen(f.pre, PROMPT1, "tw")                  # the twin, on A
    t2 = _gen(f.pre, PROMPT2, "tw", t1["context"])
    assert m2["context"] == t2["context"]
    assert "sid:mv" in _sessions(f.dec)
    moving = _sessions(f.dec)
    status, out = _post(f"{f.rt.url}/admin/drain", {"replica": 1})
    assert status == 200
    mig = out["migration"]
    assert (mig["migrated"], mig["failed"], mig["dest"]) == (
        len(moving), 0, 0), mig
    assert _sessions(f.dec) == set()
    assert moving <= _sessions(f.pre)
    snap = _metrics(f.rt.url)
    assert snap["kv_sessions_migrated_total"] == len(moving)
    assert snap.get("kv_sessions_lost_total", 0) == 0
    wa = _waked(f.pre)
    m3 = _gen(f.rt.url, PROMPT3, "mv", m2["context"])  # affinity: now A
    assert _waked(f.pre) == wa + 1
    t3 = _gen(f.pre, PROMPT3, "tw", t2["context"])
    assert m3["context"] == t3["context"]
    _post(f"{f.rt.url}/admin/undrain", {"replica": 1})

    # serve.router.migrate: every step fails, the source keeps its copy.
    before = _sessions(f.pre)
    failpoints.arm("serve.router.migrate", "raise")
    try:
        status, out = _post(f"{f.rt.url}/admin/drain", {"replica": 0})
    finally:
        failpoints.disarm_all()
        _post(f"{f.rt.url}/admin/undrain", {"replica": 0})
    assert status == 200
    assert out["migration"]["migrated"] == 0
    assert out["migration"]["failed"] == len(before)
    assert _sessions(f.pre) == before and _sessions(f.dec) == set()
    assert _metrics(f.rt.url)["router_migration_failures_total"] == \
        len(before)
    _wait_classes(f.rt.url, {f.pre: "prefill", f.dec: "decode"})


def test_a_promoted_prefix_is_pulled_by_the_other_replica(fleet):
    f = fleet

    def hot():
        got = _json(f"{f.pre}/admin/prefix")["prefixes"]
        return [h for h, m in got.items() if m["hits"] >= 1]
    # The second sighting queues the head; the loop builds it when idle;
    # a later admission hits it.
    for i in range(8):
        _gen(f.pre, SHARED + f"question {i}?", f"pfx{i}")
        if hot():
            break
        time.sleep(0.3)
    hashes = hot()
    assert hashes, "no prefix promoted and hit on the prefill replica"
    _wait(lambda: set(hashes) <= set(_json(f"{f.dec}/admin/prefix")[
        "prefixes"]), what="the decode replica to pull it")
    assert _metrics(f.rt.url)["router_prefix_syncs_total"] >= 1.0
