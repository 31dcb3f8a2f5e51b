"""The port's replica router (p2p_llm_chat_tpu_torch/serve/router.py)
in-process over the port's fronts with FakeLLM backends (no engine),
against the reference's router (p2p_llm_chat_tpu/serve/router.py).

- The reference's FakeLLM legs of tests/test_router.py on the port:
  spread, streaming and incremental NDJSON, proxied routes; 503 failover
  and the fast shed with Retry-After; unready and dead replicas; drain,
  affinity and rehome; labelled ``/metrics`` and the kv-tier fleet sums;
  the prefix share and its store-less skip; drain migration with its
  failed-export and ``serve.router.migrate`` cases; death's
  ``kv_sessions_lost_total``; the autoscaler up and down through drain.
- Parity: ``parse_metrics_text``, ``_merge_label``, ``_fleet_additive``
  and ``ReplicaRouter.session_key`` give the reference's results on a
  corpus (explicit ``session``, ``X-Session-Id``, chat-history heads,
  ``context`` ids shorter and longer than ``HEAD_GRAIN``).
- One request sequence through the port's router over port fronts and
  through the reference's router over reference fronts: the aggregated
  ``/metrics`` are equal series for series but the timing-valued ones.
- Interop: the reference's router over port fronts, and the port's
  router over reference fronts, each serve a stream and a drain that
  migrates a parked session.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.serve import FakeLLM as RefFakeLLM
from p2p_llm_chat_tpu.serve import OllamaServer as RefServer
from p2p_llm_chat_tpu.serve import kv_tier as ref_tier
from p2p_llm_chat_tpu.serve import router as ref_router
from p2p_llm_chat_tpu.utils import backoff as ref_backoff
from p2p_llm_chat_tpu.utils import failpoints as ref_failpoints
from p2p_llm_chat_tpu_torch.serve import ReplicaRouter, kv_tier
from p2p_llm_chat_tpu_torch.serve import router as port_router
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM, OverloadError
from p2p_llm_chat_tpu_torch.serve.router import (Autoscaler, _fleet_additive,
                                                 _merge_label,
                                                 parse_metrics_text)
from p2p_llm_chat_tpu_torch.utils import backoff, failpoints
from p2p_llm_chat_tpu_torch.utils.http import HttpError, http_json

torch.set_num_threads(2)


class SheddingLLM(FakeLLM):
    """A replica at capacity: every submit sheds, so its front answers
    503 + Retry-After."""

    def __init__(self, name: str = "rep") -> None:
        super().__init__(name=name)
        self.sheds = 0

    def generate_stream(self, req, stats=None):
        self.sheds += 1
        raise OverloadError("server at capacity: injected", retry_after_s=3.0)


class NotReady(FakeLLM):
    def ready(self):
        return False


class MetricsLLM(FakeLLM):
    """A backend whose snapshot is ``snap`` (already-labelled series and
    the kv-tier gauges among them)."""

    def __init__(self, snap: dict) -> None:
        super().__init__(name="rep")
        self.snap = snap

    def metrics_snapshot(self):
        return dict(self.snap)


class PrefixStoreLLM(FakeLLM):
    """A real port PrefixStore behind the share hooks (no model)."""

    def __init__(self) -> None:
        super().__init__(name="rep")
        from p2p_llm_chat_tpu_torch.serve.prefix import PrefixStore
        self.store = PrefixStore()

    def prefix_hashes(self):
        return self.store.hashes()

    def prefix_export(self, h):
        return self.store.export_payload(h)

    def prefix_import(self, data):
        return self.store.import_payload(data)


def _session_tier_llm(tier_mod, fake_cls):
    """A FakeLLM of ``fake_cls`` over a real KVTier of ``tier_mod`` behind
    the migration hooks (the engine's surface without a model)."""

    class SessionTierLLM(fake_cls):
        def __init__(self) -> None:
            super().__init__(name="rep")
            self.tier = tier_mod.KVTier(host_bytes=1 << 20)
            self.park_alls = 0

        def session_list(self):
            return self.tier.sessions_meta()

        def session_export(self, key):
            return self.tier.export_payload(key)

        def session_import(self, data):
            sess = tier_mod.deserialize_session(data)
            if sess is None or not self.tier.adopt(sess):
                return None
            return sess

        def session_forget(self, key):
            return self.tier.forget(key)

        def session_park_all(self):
            self.park_alls += 1

    return SessionTierLLM()


def _parked(tier_mod, key: str):
    """A parked 40-token session of 64 bytes in ``tier_mod``'s form."""
    if tier_mod is kv_tier:
        arr = torch.zeros(32, dtype=torch.int8)
        nbytes = 2 * arr.numel()
    else:
        arr = np.zeros(32, np.int8)
        nbytes = 2 * arr.nbytes
    return tier_mod.SessionKV(key=key, tokens=tuple(range(40)), length=40,
                              host=((arr, arr, None, None), 1),
                              nbytes=nbytes)


def _fleet(n: int = 2, backend_factory=None, router_cls=ReplicaRouter,
           server_cls=OllamaServer, **router_kw):
    """n in-process fronts + a router; returns (router, fronts)."""
    backend_factory = backend_factory or (lambda i: FakeLLM(name="rep"))
    reps = [server_cls(backend_factory(i), addr="127.0.0.1:0").start()
            for i in range(n)]
    router_kw.setdefault("scrape_ms", 100)
    rt = router_cls([r.url for r in reps], addr="127.0.0.1:0",
                    **router_kw).start()
    return rt, reps


def _stop(rt, reps):
    rt.stop()
    for r in reps:
        try:
            r.stop()
        except Exception:          # noqa: BLE001 — already stopped
            pass


def _routed(rt) -> list:
    _, body = http_json("GET", f"{rt.url}/admin/replicas")
    return [r["routed"] for r in body["replicas"]]


def _gen(url: str, prompt: str, stream: bool = False, session: str = None,
         timeout: float = 30):
    headers = {"Content-Type": "application/json"}
    if session:
        headers["X-Session-Id"] = session
    req = urllib.request.Request(
        f"{url}/api/generate",
        data=json.dumps({"model": "rep", "prompt": prompt,
                         "stream": stream}).encode(),
        headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
    if stream:
        return [json.loads(line) for line in raw.splitlines()]
    return json.loads(raw)


def _router_metrics(rt) -> dict:
    with urllib.request.urlopen(f"{rt.url}/metrics", timeout=5) as r:
        return parse_metrics_text(r.read().decode())


def _wait(fn, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


# -- routing + wire contract -------------------------------------------------

def _leg_spread(rt):
    for i in range(8):
        body = _gen(rt.url, f"req number {i}\n\nReply:")
        assert body["done"] is True and f"req number {i}" in body["response"]
    routed = _routed(rt)
    assert sum(routed) == 8 and all(n > 0 for n in routed), routed


def _leg_stream(rt):
    lines = _gen(rt.url, "stream me please\n\nReply:", stream=True)
    assert len(lines) >= 2
    assert all(not line["done"] for line in lines[:-1])
    assert lines[-1]["done"] is True
    assert "stream me please" in "".join(line.get("response", "")
                                         for line in lines)


def _leg_proxied(rt):
    st, body = http_json("POST", f"{rt.url}/api/chat", {
        "model": "rep",
        "messages": [{"role": "user", "content": "lunch tomorrow?"}],
        "stream": False})
    assert st == 200 and "lunch tomorrow?" in body["message"]["content"]
    st, body = http_json("POST", f"{rt.url}/api/embed",
                         {"model": "rep", "input": ["a", "b"]})
    assert st == 200 and len(body["embeddings"]) == 2
    st, tags = http_json("GET", f"{rt.url}/api/tags")
    assert st == 200 and tags["models"][0]["name"] == "rep"
    st, ver = http_json("GET", f"{rt.url}/api/version")
    assert st == 200 and ver["version"] == "0.1.0-p2p-llm-chat-tpu"
    with urllib.request.urlopen(f"{rt.url}/", timeout=5) as r:
        assert r.read() == b"Ollama is running"
    with pytest.raises(HttpError) as e:           # 501 is an answer
        http_json("POST", f"{rt.url}/api/pull", {"name": "x"})
    assert e.value.status == 501


@pytest.mark.parametrize("leg", [_leg_spread, _leg_stream, _leg_proxied],
                         ids=["spread", "stream", "proxied"])
def test_routing_over_port_fronts(leg):
    rt, reps = _fleet(2)
    try:
        leg(rt)
    finally:
        _stop(rt, reps)


def test_streaming_is_incremental_through_router():
    """Tokens forward as the replica produces them (read1, not read(n)):
    the first line arrives well before the stream completes."""
    slow = FakeLLM(name="rep", token_delay_s=0.15)
    rt, reps = _fleet(1, backend_factory=lambda i: slow)
    try:
        req = urllib.request.Request(
            f"{rt.url}/api/generate",
            data=json.dumps({"model": "rep",
                             "prompt": "incremental streaming check"
                                       "\n\nReply:"}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.monotonic()
        with urllib.request.urlopen(req, timeout=30) as resp:
            first = resp.readline()
            t_first = time.monotonic() - t0
            rest = resp.read()
        t_total = time.monotonic() - t0
        assert first and json.loads(first)["done"] is False and rest
        assert t_total > 0.6, t_total
        assert t_first < 0.5 * t_total, (t_first, t_total)
    finally:
        _stop(rt, reps)


# -- backpressure: failover, saturation, readiness ---------------------------

def test_503_fails_over_to_healthy_replica():
    shedding = SheddingLLM()
    rt, reps = _fleet(2, backend_factory=lambda i: (
        shedding if i == 0 else FakeLLM(name="rep")))
    try:
        r0 = backoff.retries_total()
        for i in range(4):
            assert _gen(rt.url, f"failover {i}\n\nReply:")["done"] is True
        _, body = http_json("GET", f"{rt.url}/admin/replicas")
        by_idx = {r["index"]: r for r in body["replicas"]}
        assert shedding.sheds >= 1 and by_idx[1]["routed"] >= 4
        snap = _router_metrics(rt)
        assert snap["router_retries_total"] == shedding.sheds
        assert backoff.retries_total() - r0 == shedding.sheds
    finally:
        _stop(rt, reps)


def test_saturated_fleet_sheds_fast_with_retry_after():
    rt, reps = _fleet(2, backend_factory=lambda i: SheddingLLM())
    try:
        t0 = time.monotonic()
        with pytest.raises(HttpError) as e:
            http_json("POST", f"{rt.url}/api/generate",
                      {"model": "rep", "prompt": "x", "stream": False},
                      timeout=10)
        elapsed = time.monotonic() - t0
        assert e.value.status == 503
        assert elapsed < 0.1, f"shed took {elapsed * 1e3:.0f} ms"
        req = urllib.request.Request(
            f"{rt.url}/api/generate",
            data=json.dumps({"model": "rep", "prompt": "x",
                             "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as he:
            urllib.request.urlopen(req, timeout=10)
        assert he.value.headers.get("Retry-After") == "3"
        he.value.close()
        assert _router_metrics(rt)["router_requests_shed_total"] == 2.0
    finally:
        _stop(rt, reps)


def test_unready_replica_excluded_and_fleet_readyz():
    rt, reps = _fleet(2, backend_factory=lambda i: (
        NotReady(name="rep") if i == 0 else FakeLLM(name="rep")))
    try:
        for i in range(3):
            _gen(rt.url, f"warmgate {i}\n\nReply:")
        assert _routed(rt) == [0, 3]
        assert http_json("GET", f"{rt.url}/readyz")[0] == 200
    finally:
        _stop(rt, reps)
    rt, reps = _fleet(2, backend_factory=lambda i: NotReady(name="rep"))
    try:
        time.sleep(0.3)
        with pytest.raises(HttpError) as e:
            http_json("GET", f"{rt.url}/readyz")
        assert e.value.status == 503
    finally:
        _stop(rt, reps)


def test_dead_replica_marked_unreachable_and_skipped():
    rt, reps = _fleet(2)
    try:
        reps[0].stop()
        for i in range(4):
            assert _gen(rt.url, f"survivor {i}\n\nReply:")["done"] is True
        with rt._mu:
            assert rt.replicas[0].alive is False
    finally:
        _stop(rt, reps[1:])


# -- draining, affinity ------------------------------------------------------

def test_drain_completes_inflight_and_routes_away():
    slow = FakeLLM(name="rep", token_delay_s=0.08)
    rt, reps = _fleet(2, backend_factory=lambda i: (
        slow if i == 0 else FakeLLM(name="rep")))
    try:
        _gen(rt.url, "pin\n\nReply:", session="s-drain")
        home = next(i for i, n in enumerate(_routed(rt)) if n)
        lines: list = []
        errs: list = []

        def stream_worker():
            try:
                lines.extend(_gen(rt.url, "long slow stream here\n\nReply:",
                                  stream=True, session="s-drain"))
            except Exception as e:          # noqa: BLE001
                errs.append(e)

        th = threading.Thread(target=stream_worker)
        th.start()
        time.sleep(0.15)
        st, _ = http_json("POST", f"{rt.url}/admin/drain", {"replica": home})
        assert st == 200
        th.join(timeout=30)
        assert not errs, errs
        assert lines and lines[-1]["done"] is True
        rep_url = reps[home].url
        with pytest.raises(HttpError) as e:
            http_json("GET", f"{rep_url}/readyz")
        assert e.value.status == 503
        before = _routed(rt)
        for i in range(3):
            _gen(rt.url, f"post drain {i}\n\nReply:", session="s-drain")
        assert _routed(rt)[home] == before[home]
        st, _ = http_json("POST", f"{rt.url}/admin/undrain",
                          {"replica": rep_url})
        assert st == 200 and http_json("GET", f"{rep_url}/readyz")[0] == 200
        with pytest.raises(HttpError) as e:
            http_json("POST", f"{rt.url}/admin/drain", {"replica": 9})
        assert e.value.status == 404
    finally:
        _stop(rt, reps)


def test_session_affinity_pins_and_rehomes():
    rt, reps = _fleet(3)
    try:
        _gen(rt.url, "first\n\nReply:", session="conv-1")
        home = next(i for i, n in enumerate(_routed(rt)) if n)
        for i in range(5):
            _gen(rt.url, f"turn {i}\n\nReply:", session="conv-1")
        assert _routed(rt)[home] == 6
        http_json("POST", f"{rt.url}/admin/drain", {"replica": home})
        for i in range(3):
            _gen(rt.url, f"rehomed {i}\n\nReply:", session="conv-1")
        routed2 = _routed(rt)
        assert routed2[home] == 6
        new_home = max((n, i) for i, n in enumerate(routed2) if i != home)[1]
        assert routed2[new_home] == 3       # the session stayed rehomed
    finally:
        _stop(rt, reps)


# -- metrics aggregation -----------------------------------------------------

@pytest.mark.parametrize("case", ["labelled", "kv_tier"])
def test_metrics_replica_labels_and_fleet_totals(case):
    """Per-replica series get ``replica="i"`` merged into their brace
    block; counters, histogram components and the additive gauges sum
    into unlabelled fleet totals; quantiles stay per replica."""
    if case == "labelled":
        snaps = [{"serve_batch_occupancy": float(i + 1),
                  'serve_spec_proposed_total{source="ngram"}': 5.0 * (i + 1)}
                 for i in range(2)]
    else:
        snaps = [{"kv_parked_sessions": float(i + 1),
                  "kv_open_sessions": float(i + 2),
                  "kv_host_bytes": 1000.0 * (i + 1),
                  "kv_waked_total": float(i + 1),
                  "kv_wake_p50_ms": 5.0} for i in range(2)]
    rt, reps = _fleet(2, backend_factory=lambda i: MetricsLLM(snaps[i]))
    try:
        for i in range(4):
            _gen(rt.url, f"traffic {i}\n\nReply:")
        snap = _router_metrics(rt)
        for series in snaps[0]:
            for i in (0, 1):
                assert snap[_merge_label(series, f'replica="{i}"')] == \
                    snaps[i][series]
            if series == "kv_wake_p50_ms":
                assert series not in snap   # no fabricated fleet quantile
            else:
                assert snap[series] == snaps[0][series] + snaps[1][series]
        assert (snap["serve_requests_total"] == 4.0
                == snap['serve_requests_total{replica="0"}']
                + snap['serve_requests_total{replica="1"}'])
        assert snap["router_requests_total"] == 4.0
        assert snap['router_routed_total{replica="1"}'] >= 1
        assert snap['serve_replica_class{class="mixed",replica="0"}'] == 1
        assert snap['router_pool_replicas{class="mixed"}'] == 2
    finally:
        _stop(rt, reps)


# -- the shared prefix tier --------------------------------------------------

def test_prefix_share_syncs_replicas():
    from p2p_llm_chat_tpu_torch.serve.prefix import PrefixEntry, token_hash
    backends = []

    def factory(i):
        backends.append(PrefixStoreLLM())
        return backends[-1]

    rt, reps = _fleet(2, backend_factory=factory, prefix_share=True)
    try:
        ids = tuple(range(40))
        k = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 40, 2, 4)).astype(np.float32))
        backends[0].store.put(PrefixEntry(ids=ids, k=k, v=k + 1, hits=3))
        assert _wait(lambda: len(backends[1].store) >= 1), "never synced"
        got = backends[1].store.snapshot()
        assert got[0].ids == ids and got[0].token_hash == token_hash(ids)
        assert torch.equal(got[0].k, k) and torch.equal(got[0].v, k + 1)
        assert _router_metrics(rt)["router_prefix_syncs_total"] >= 1.0
        time.sleep(0.4)
        assert len(backends[1].store) == 1
    finally:
        _stop(rt, reps)


def test_prefix_share_skips_storeless_replicas():
    rt, reps = _fleet(2, prefix_share=True)
    try:
        time.sleep(0.5)
        snap = _router_metrics(rt)
        assert snap.get("router_prefix_syncs_total", 0) == 0
        assert snap.get("router_prefix_sync_failures_total", 0) == 0
        with rt._mu:
            assert rt._prefix_unsupported == {0, 1}
            assert rt._session_unsupported == {0, 1}
    finally:
        _stop(rt, reps)


# -- live session migration, death, autoscaling ------------------------------

def _tier_fleet(n: int = 2):
    backends: list = []

    def factory(i):
        backends.append(_session_tier_llm(kv_tier, FakeLLM))
        return backends[-1]

    rt, reps = _fleet(n, backend_factory=factory)
    return rt, reps, backends


@pytest.mark.parametrize("fault", [None, "serve.kv_tier.export",
                                   "serve.router.migrate"])
def test_drain_migrates_sessions(fault):
    """Drain-as-migration over real tiers: every session parked on the
    drained replica moves (export -> import -> forget on ack) and the
    affinity flips, head: keys included; under the export or the
    router's migrate failpoint the step fails, the source keeps the
    session and a request through the router still completes."""
    rt, reps, backends = _tier_fleet()
    keys = {"sid:conv-mig", "head:cafebabe12345678"}
    try:
        for k in keys:
            backends[0].tier.insert(_parked(kv_tier, k))
        if fault:
            failpoints.arm(fault, "raise")
        try:
            st, body = http_json("POST", f"{rt.url}/admin/drain",
                                 {"replica": 0})
        finally:
            failpoints.disarm_all()
        assert st == 200
        mig = body["migration"]
        assert backends[0].park_alls == 1
        snap = _router_metrics(rt)
        if fault is None:
            assert (mig["migrated"], mig["failed"], mig["dest"]) == (2, 0, 1)
            assert set(backends[1].tier.sessions_meta()) == keys
            assert backends[0].tier.sessions_meta() == {}
            assert backends[0].tier.stats()["evicted_total"] == 0
            with rt._mu:
                assert rt._sessions["conv-mig"] == 1
                assert rt._sessions["head:cafebabe12345678"] == 1
            assert snap["kv_sessions_migrated_total"] == 2.0
            assert snap["router_migration_ms_count"] == 2.0
        else:
            assert (mig["migrated"], mig["failed"]) == (0, 2)
            assert set(backends[0].tier.sessions_meta()) == keys
            assert backends[1].tier.sessions_meta() == {}
            assert snap["router_migration_failures_total"] == 2.0
            assert snap["kv_sessions_migrated_total"] == 0.0
        assert snap.get("kv_sessions_lost_total", 0) == 0.0
        assert _gen(rt.url, "still serving\n\nReply:")["done"] is True
    finally:
        _stop(rt, reps)


def test_dead_replica_counts_lost_sessions_and_rehomes():
    rt, reps, backends = _tier_fleet()
    try:
        _gen(rt.url, "pin me\n\nReply:", session="doomed-1")
        with rt._mu:
            home = rt._sessions["doomed-1"]
        backends[home].tier.insert(_parked(kv_tier, "sid:doomed-1"))
        home_rep = next(r for r in rt._replica_snapshot() if r.index == home)

        def seen():
            with rt._mu:
                return "sid:doomed-1" in (home_rep.sessions or ())
        assert _wait(seen, 5.0), "scrape never observed the session"
        reps[home].stop()
        assert _gen(rt.url, "follow-up\n\nReply:",
                    session="doomed-1")["done"] is True
        assert _wait(lambda: _router_metrics(rt).get(
            "kv_sessions_lost_total", 0.0) >= 1.0, 5.0)
        assert _router_metrics(rt)["kv_sessions_lost_total"] == 1.0
        with rt._mu:
            assert rt._sessions.get("doomed-1") != home
    finally:
        _stop(rt, reps)


def test_autoscaler_scales_up_then_down_via_drain():
    class DepthLLM(FakeLLM):
        def __init__(self):
            super().__init__(name="rep")
            self.depth = 50.0

        def metrics_snapshot(self):
            return {"serve_queue_depth": self.depth}

    base = DepthLLM()
    spawned: list = []
    retired: list = []

    def spawn():
        srv = OllamaServer(FakeLLM(name="rep"), addr="127.0.0.1:0").start()
        spawned.append(srv)
        return srv.url

    def retire(url):
        retired.append(url)
        for s in spawned:
            if s.url == url:
                s.stop()

    rt, reps = _fleet(1, backend_factory=lambda i: base, scrape_ms=50)
    rt.attach_autoscaler(Autoscaler(
        spawn_fn=spawn, retire_fn=retire,
        can_retire_fn=lambda url: any(s.url == url for s in spawned),
        min_replicas=1, max_replicas=2, up_q=4.0, down_q=0.5, sustain=2))
    try:
        assert _wait(lambda: len(http_json(
            "GET", f"{rt.url}/admin/replicas")[1]["replicas"]) == 2)
        assert len(spawned) == 1
        assert _router_metrics(rt)["router_autoscale_up_total"] == 1.0
        base.depth = 0.0
        assert _wait(lambda: len(http_json(
            "GET", f"{rt.url}/admin/replicas")[1]["replicas"]) == 1)
        assert retired == [spawned[0].url]
        body = http_json("GET", f"{rt.url}/admin/replicas")[1]
        assert body["replicas"][0]["index"] == 0
        assert _router_metrics(rt)["router_autoscale_down_total"] == 1.0
        assert _gen(rt.url, "post scale\n\nReply:")["done"] is True
    finally:
        _stop(rt, reps + spawned)


# -- parity with the reference -----------------------------------------------

METRICS_TEXTS = [
    "# TYPE a counter\na 1.5\nb{x=\"y z\"} 2\nmalformed\n# c 9\n",
    "",
    "  \n\t\nx_total 3\nx_total 4\n",
    'm{model="a",quantile="0.5"} 0.25\nm_sum 1e3\nm_count 7\nn NaN\n',
    "no_value \nspace name 1\ninf_g +Inf\nneg -2.5e-3\n",
]


@pytest.mark.parametrize("text", METRICS_TEXTS)
def test_parse_metrics_text_equals_reference(text):
    got = parse_metrics_text(text)
    want = ref_router.parse_metrics_text(text)
    assert list(got) == list(want)
    assert all(got[k] == want[k] or (got[k] != got[k] and want[k] != want[k])
               for k in want)


@pytest.mark.parametrize("series", [
    "m_total", 'm_total{a="b"}', 'm{model="x",source="ngram"}', "m{}",
    'kv_wake_p50_ms{model="x"}', ""])
@pytest.mark.parametrize("label", ['replica="2"', 'replica="10"'])
def test_merge_label_equals_reference(series, label):
    assert _merge_label(series, label) == ref_router._merge_label(series,
                                                                  label)


@pytest.mark.parametrize("series", [
    "serve_requests_total", 'serve_spec_accepted_total{source="model"}',
    "router_migration_ms_count", "router_migration_ms_sum",
    'serve_ttft_seconds{quantile="0.5"}',
    'serve_ttft_seconds{model="a",quantile="0.95"}',
    "serve_queue_depth", 'serve_queue_depth{model="small"}',
    "serve_batch_slots", "kv_host_bytes", "prefix_bytes",
    "serve_prefix_entries", "kv_wake_p95_ms", "paged_flash_min_w",
    "decode_fused_mean_k", 'serve_replica_class{class="decode"}'])
def test_fleet_additive_equals_reference(series):
    assert _fleet_additive(series) == ref_router._fleet_additive(series)


_U0 = {"role": "user", "content": "hello"}
_SYS = {"role": "system", "content": "You are helpful."}
_A0 = {"role": "assistant", "content": "hi there"}
SESSION_CORPUS = {
    "header": ("/api/generate", {}, {"x-session-id": "abc"}),
    "header_beats_body": ("/api/chat", {"session": "b"},
                          {"x-session-id": "h"}),
    "body": ("/api/generate", {"session": "s9"}, {}),
    "body_int": ("/api/generate", {"session": 17}, {}),
    "chat_one": ("/api/chat", {"messages": [_U0]}, {}),
    "chat_head": ("/api/chat", {"messages": [_SYS, _U0, _A0, _U0]}, {}),
    "chat_other": ("/api/chat", {"messages": [
        _SYS, {"role": "user", "content": "different opener"}]}, {}),
    "chat_empty": ("/api/chat", {"messages": []}, {}),
    "chat_junk": ("/api/chat", {"messages": ["x", 3]}, {}),
    "chat_ctx_ignored": ("/api/chat", {"context": list(range(40))}, {}),
    "ctx_short": ("/api/generate", {"context": [1, 2, 3]}, {}),
    "ctx_grain_minus": ("/api/generate",
                        {"context": list(range(kv_tier.HEAD_GRAIN - 1))}, {}),
    "ctx_grain": ("/api/generate",
                  {"context": list(range(kv_tier.HEAD_GRAIN))}, {}),
    "ctx_long": ("/api/generate",
                 {"context": list(range(5, 5 + 3 * kv_tier.HEAD_GRAIN))}, {}),
    "ctx_floats": ("/api/generate",
                   {"context": [float(i) for i in range(40)]}, {}),
    "ctx_bools": ("/api/generate", {"context": [True] * 40}, {}),
    "one_shot": ("/api/generate", {"prompt": "one shot"}, {}),
}


@pytest.mark.parametrize("case", sorted(SESSION_CORPUS))
def test_session_key_equals_reference(case):
    path, body, headers = SESSION_CORPUS[case]
    got = ReplicaRouter.session_key(path, body, headers)
    assert got == ref_router.ReplicaRouter.session_key(path, body, headers)
    if case == "ctx_long":          # the tier's anonymous key, both sides
        assert got == kv_tier.head_key(body["context"]) == \
            ref_tier.head_key(body["context"])


# Timing-valued series: their values are wall clocks, equal nowhere.
TIMING = {"serve_ttft_seconds", "serve_ttft_seconds_sum",
          "serve_request_seconds", "serve_request_seconds_sum"}


def _sequence(router_cls, server_cls, fake_cls):
    rt, reps = _fleet(2, backend_factory=lambda i: fake_cls(name="rep"),
                      router_cls=router_cls, server_cls=server_cls)
    try:
        for i in range(4):
            _gen(rt.url, f"parity {i}\n\nReply:")
        _gen(rt.url, "parity stream\n\nReply:", stream=True)
        for i in range(3):
            _gen(rt.url, f"pinned {i}\n\nReply:", session="par")
        http_json("POST", f"{rt.url}/api/chat", {
            "model": "rep", "stream": False,
            "messages": [{"role": "user", "content": "chat parity"}]})
        http_json("POST", f"{rt.url}/api/embed", {"model": "rep",
                                                  "input": ["a", "b"]})
        http_json("POST", f"{rt.url}/admin/drain", {"replica": 1})
        _gen(rt.url, "after drain\n\nReply:")
        http_json("POST", f"{rt.url}/admin/undrain", {"replica": 1})
        # The ready gauges follow the scrape loop: read them once it has
        # seen the undrained replica ready again on this router too.
        assert _wait(lambda: all(r["ready"] for r in http_json(
            "GET", f"{rt.url}/admin/replicas")[1]["replicas"]))
        return _router_metrics(rt)
    finally:
        _stop(rt, reps)


def test_aggregated_metrics_equal_reference(monkeypatch):
    """The same request sequence through each package's router over its
    own FakeLLM fronts: the aggregated ``/metrics`` hold the same series
    with the same values, timing-valued series excepted by name. The
    process-wide retry and failpoint counters start at 0 on both sides."""
    for mod in (backoff, ref_backoff):
        monkeypatch.setattr(mod, "_retries_total", 0)
    failpoints.reset_hits()
    ref_failpoints.reset_hits()
    got = _sequence(ReplicaRouter, OllamaServer, FakeLLM)
    want = _sequence(ref_router.ReplicaRouter, RefServer, RefFakeLLM)
    assert list(got) == list(want)
    differ = {k: (got[k], want[k]) for k in want
              if k.split("{", 1)[0] not in TIMING and got[k] != want[k]}
    assert differ == {}
    assert got["router_requests_total"] == 11.0
    assert got['serve_requests_total{replica="0"}'] + \
        got['serve_requests_total{replica="1"}'] == 10.0


@pytest.mark.parametrize("pair", ["ref_router_port_fronts",
                                  "port_router_ref_fronts"])
def test_interop_stream_and_drain(pair):
    """Each router fronts the other package's replicas: a stream passes
    through whole, and a drain migrates a parked session between the
    fronts (the router moves control JSON, the fronts the payload)."""
    if pair == "ref_router_port_fronts":
        router_cls, server_cls = ref_router.ReplicaRouter, OllamaServer
        tier_mod, fake_cls = kv_tier, FakeLLM
    else:
        router_cls, server_cls = ReplicaRouter, RefServer
        tier_mod, fake_cls = ref_tier, RefFakeLLM
    backends: list = []

    def factory(i):
        backends.append(_session_tier_llm(tier_mod, fake_cls))
        return backends[-1]

    rt, reps = _fleet(2, backend_factory=factory, router_cls=router_cls,
                      server_cls=server_cls)
    try:
        lines = _gen(rt.url, "interop stream\n\nReply:", stream=True)
        assert len(lines) >= 2 and lines[-1]["done"] is True
        assert "interop stream" in "".join(line.get("response", "")
                                           for line in lines)
        backends[0].tier.insert(_parked(tier_mod, "sid:inter"))
        st, body = http_json("POST", f"{rt.url}/admin/drain", {"replica": 0})
        assert st == 200
        assert body["migration"] == {"migrated": 1, "failed": 0, "dest": 1,
                                     "sessions": 1}
        assert set(backends[1].tier.sessions_meta()) == {"sid:inter"}
        assert backends[0].tier.sessions_meta() == {}
        with rt._mu:
            assert rt._sessions["inter"] == 1
        assert _gen(rt.url, "after\n\nReply:",
                    session="inter")["done"] is True
        assert _routed(rt)[1] >= 1
    finally:
        _stop(rt, reps)


def test_port_router_has_every_name_of_the_reference():
    names = {n for n in dir(ref_router) if not n.startswith("__")}
    assert {n for n in names if not hasattr(port_router, n)} == set()
