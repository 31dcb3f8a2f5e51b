"""Port-only twins of the reference's chat-plane cases: the node's HTTP
surface and lookup ladder, the directory, the relay and hole punching,
at-least-once delivery under churn, NAT-PMP against a fake gateway, and
the entry points as processes that see no card."""

import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from p2p_llm_chat_tpu_torch.directory import DirectoryService
from p2p_llm_chat_tpu_torch.node import ChatNode
from p2p_llm_chat_tpu_torch.p2p import P2PHost
from p2p_llm_chat_tpu_torch.p2p.natpmp import (PROTO_TCP, NatPmpClient,
                                               NatPmpError,
                                               NatPmpUnavailable, PortMapper)
from p2p_llm_chat_tpu_torch.p2p.udp import ReliableDgram
from p2p_llm_chat_tpu_torch.proto import ChatMessage, mint_msg_id, now_rfc3339
from p2p_llm_chat_tpu_torch.relay import RelayService
from p2p_llm_chat_tpu_torch.utils import failpoints as fp
from p2p_llm_chat_tpu_torch.utils.http import HttpError, http_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    fp.disarm_all()
    fp.reset_hits()


def _node(user, dir_url, **kw):
    kw.setdefault("http_addr", "127.0.0.1:0")
    kw.setdefault("bootstrap_addrs", "")
    kw.setdefault("relay_addrs", "")
    kw.setdefault("identity_file", "")
    kw.setdefault("dht_addr", "off")
    return ChatNode(username=user, directory_url=dir_url, **kw).start()


def _send(node, to, content, **kw):
    return http_json("POST", f"{node.http_url}/send",
                     {"to_username": to, "content": content},
                     timeout=20.0, **kw)


def _metric(node, head):
    with urllib.request.urlopen(f"{node.http_url}/metrics", timeout=5) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(head) and not line.startswith("#"):
            return float(line.rsplit(" ", 1)[1])
    return None


def _wait_inbox(node, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        _, inbox = http_json("GET", f"{node.http_url}/inbox?after=",
                             timeout=5.0)
        if len(inbox) >= want:
            return inbox
        assert time.monotonic() < deadline, (
            f"inbox never reached {want} (has {len(inbox)})")
        time.sleep(0.03)


@pytest.fixture()
def pair():
    directory = DirectoryService(addr="127.0.0.1:0").start()
    a = _node("najy", directory.url)
    b = _node("cannan", directory.url)
    yield directory, a, b
    for s in (a, b, directory):
        s.stop()


def test_node_http_surface(pair):
    directory, a, b = pair
    _, me = http_json("GET", f"{a.http_url}/me", timeout=5.0)
    assert me["username"] == "najy" and me["peer_id"] == a.host.peer_id
    assert me["addrs"] and all(x.endswith(a.host.peer_id)
                               for x in me["addrs"])
    assert http_json("GET", f"{a.http_url}/healthz")[1] == {"status": "ok"}
    for body in ({"to_username": "cannan"}, {"content": "x"}):
        status, _ = http_json("POST", f"{a.http_url}/send", body,
                              raise_for_status=False)
        assert status == 400
    status, _ = _send(a, "nobody", "x", raise_for_status=False)
    assert status == 404
    for i in range(2):
        assert _send(a, "cannan", f"a{i}")[1]["status"] == "sent"
    assert _send(b, "najy", "b0")[1]["status"] == "sent"
    inbox = _wait_inbox(b, 2)
    assert [m["content"] for m in inbox] == ["a0", "a1"]
    assert inbox[0]["from_user"] == "najy" and inbox[0]["msg_id"]
    after = http_json("GET", f"{b.http_url}/inbox?after={inbox[0]['id']}")[1]
    assert [m["content"] for m in after] == ["a1"]
    assert [m["content"] for m in _wait_inbox(a, 1)] == ["b0"]
    assert _metric(a, "p2p_delivery_ms_count") == 2
    traces = http_json("GET", f"{a.http_url}/admin/trace")[1]
    assert len(traces["traces"]) == 2 and traces["stats"]["spans"] == 2


def test_directory_register_lookup_deregister_and_ttl():
    directory = DirectoryService(addr="127.0.0.1:0").start()
    ttl = DirectoryService(addr="127.0.0.1:0", ttl_seconds=0.15).start()
    try:
        url = directory.url
        for body in ({"username": "x"}, {"peer_id": "p"},
                     {"username": "x", "peer_id": "p", "addrs": "no"}):
            status, _ = http_json("POST", f"{url}/register", body,
                                  raise_for_status=False)
            assert status == 400
        for peer in ("P1", "P2"):       # last writer wins
            http_json("POST", f"{url}/register", {
                "username": 'a"b', "peer_id": peer, "addrs": ["/x"]})
        _, rec = http_json("GET", f"{url}/lookup?username=a%22b")
        assert rec["peer_id"] == "P2" and rec["last"].endswith("Z")
        http_json("POST", f"{url}/deregister",
                  {"username": 'a"b', "peer_id": "P1"})   # not the owner
        assert http_json("GET", f"{url}/lookup?username=a%22b")[0] == 200
        http_json("POST", f"{url}/deregister",
                  {"username": 'a"b', "peer_id": "P2"})
        with pytest.raises(HttpError) as e:
            http_json("GET", f"{url}/lookup?username=a%22b")
        assert e.value.status == 404
        http_json("POST", f"{ttl.url}/register",
                  {"username": "gone", "peer_id": "P", "addrs": []})
        time.sleep(0.5)
        status, _ = http_json("GET", f"{ttl.url}/lookup?username=gone",
                              raise_for_status=False)
        assert status == 404
        with urllib.request.urlopen(f"{ttl.url}/metrics", timeout=5) as r:
            assert b"directory_evictions_total 1" in r.read()
    finally:
        directory.stop()
        ttl.stop()


def test_warm_pair_survives_a_directory_outage_and_reregisters(monkeypatch):
    monkeypatch.setenv("NODE_REREGISTER_S", "0.3")
    directory = DirectoryService(addr="127.0.0.1:0").start()
    port = int(directory.url.rsplit(":", 1)[1])
    a = _node("najy", directory.url)
    b = _node("cannan", directory.url)
    directory2 = None
    try:
        _send(a, "cannan", "warmup")
        directory.stop()
        assert _send(a, "cannan", "through the outage")[0] == 200
        assert [m["content"] for m in _wait_inbox(b, 2)][-1] == \
            "through the outage"
        assert _send(b, "nobody", "x", raise_for_status=False)[0] == 404
        deadline = time.monotonic() + 5
        while directory2 is None:
            try:
                directory2 = DirectoryService(
                    addr=f"127.0.0.1:{port}").start()
            except OSError:
                assert time.monotonic() < deadline, "port never freed"
                time.sleep(0.1)
        deadline = time.monotonic() + 5
        while True:
            status, rec = http_json(
                "GET", f"{directory2.url}/lookup?username=najy",
                raise_for_status=False)
            if status == 200:
                break
            assert time.monotonic() < deadline, "never re-registered"
            time.sleep(0.1)
        assert rec["peer_id"] == a.host.peer_id
    finally:
        for s in (a, b, directory2):
            if s is not None:
                s.stop()


def _dgram_pair():
    socks = []
    for _ in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    return (ReliableDgram(socks[0], socks[1].getsockname()),
            ReliableDgram(socks[1], socks[0].getsockname()))


def test_reliable_dgram_stream_and_timeout():
    ra, rb = _dgram_pair()
    try:
        payload = bytes(range(256)) * 40       # several datagrams
        ra.sendall(payload)
        rb.sendall(b"world")
        buf = b""
        while len(buf) < len(payload):
            chunk = rb.recv(len(payload) - len(buf))
            assert chunk
            buf += chunk
        assert buf == payload
        assert ra.recv(5) == b"world"
        ra.shutdown(socket.SHUT_WR)
        assert rb.recv(10) == b""
        ra.settimeout(0.2)
        with pytest.raises(socket.timeout):
            ra.recv(1)
    finally:
        ra.close()
        rb.close()


@pytest.mark.parametrize("punch", [True, False])
def test_circuit_dial_punched_or_spliced(punch, monkeypatch):
    monkeypatch.setenv("P2P_HOLEPUNCH", "1" if punch else "0")
    relay = RelayService(addr="127.0.0.1:0").start()
    target = P2PHost(listen_addr="127.0.0.1:0").start()
    dialer = P2PHost(listen_addr="127.0.0.1:0").start()
    got, done = {}, threading.Event()

    def handler(stream, remote_peer_id):
        got["data"], got["peer"] = stream.read_all(), remote_peer_id
        stream.close()
        done.set()
    target.set_stream_handler("/test/1.0.0", handler)
    target.reserve_on_relay(relay.addr())
    try:
        deadline = time.monotonic() + 5
        while target.peer_id not in relay._reservations:
            assert time.monotonic() < deadline, "no reservation"
            time.sleep(0.02)
        circuit = relay.addr().with_peer(target.peer_id).circuit_via(
            relay.peer_id)
        stream = dialer.new_stream(circuit, "/test/1.0.0", timeout=5.0)
        assert stream.remote_peer_id == target.peer_id
        stream.send_frame(b"through the circuit")
        stream.close_write()
        assert done.wait(10)
        assert got == {"data": b"through the circuit",
                       "peer": dialer.peer_id}
        assert relay._n_spliced == (0 if punch else 1)
        assert relay.pump in ((None,) if punch else ("native", "python"))
    finally:
        dialer.close()
        target.close()
        relay.stop()


def test_churn_exactly_once_across_restart(tmp_path):
    directory = DirectoryService(addr="127.0.0.1:0").start()
    key = str(tmp_path / "cannan.key")
    a = _node("najy", directory.url)
    b = _node("cannan", directory.url, identity_file=key)
    b2 = None
    try:
        _send(a, "cannan", "warmup")
        _wait_inbox(b, 1)
        b.stop()
        sent = [f"through the window #{i} ✨" for i in range(3)]
        for body in sent:
            status, resp = _send(a, "cannan", body)
            assert status == 200 and resp["status"] == "queued"
            assert resp["msg_id"]
        b2 = _node("cannan", directory.url, identity_file=key)
        assert b2.host.peer_id == b.host.peer_id
        assert [m["content"] for m in _wait_inbox(b2, 3, 15.0)] == sent
        assert _metric(a, "p2p_redelivered_total") >= 3
        assert _metric(a, "p2p_outbox_depth") == 0
        assert _metric(a, 'p2p_messages_dropped_total{reason="ttl"}') == 0
    finally:
        for s in (a, b2, directory):
            if s is not None:
                s.stop()


def test_dedup_and_fresh_ids_after_a_sender_restart(pair):
    directory, a, b = pair
    rec = a.dir.lookup("cannan")
    msg = ChatMessage(from_user="najy", to_user="cannan", content="dup?",
                      timestamp=now_rfc3339(),
                      msg_id=mint_msg_id("najy", 999, "dup?"))
    for _ in range(2):                  # a lost ack forces exactly this
        errors = []
        assert a._deliver(rec, msg, errors), errors
    assert _metric(b, "p2p_dedup_suppressed_total") == 1
    _send(a, "cannan", "hi")
    a2 = _node("najy", directory.url)   # the sender again, a new boot
    try:
        _send(a2, "cannan", "hi")
        inbox = _wait_inbox(b, 3)
        assert [m["content"] for m in inbox] == ["dup?", "hi", "hi"]
        assert len({m["msg_id"] for m in inbox}) == 3
    finally:
        a2.stop()


def test_send_joins_parked_backlog_preserving_order(pair):
    """A fresh /send to a recipient with a parked backlog joins the
    queue behind it. ``p2p.node.resolve`` is armed BEFORE
    ``p2p.node.deliver`` is disarmed, so the redelivery worker cannot
    flush the backlog in between and the second send always meets it."""
    directory, a, b = pair
    _send(a, "cannan", "warmup")
    _wait_inbox(b, 1)
    fp.arm("p2p.node.deliver", "raise")
    assert _send(a, "cannan", "first")[1]["status"] == "queued"
    with a._flush_mu:                   # no redelivery round in flight
        fp.arm("p2p.node.resolve", "raise")
        fp.disarm("p2p.node.deliver")
    assert a.outbox.depth() == 1
    assert _send(a, "cannan", "second")[1]["status"] == "queued"
    fp.disarm("p2p.node.resolve")
    inbox = _wait_inbox(b, 3, timeout=15.0)
    assert [m["content"] for m in inbox] == ["warmup", "first", "second"]


def test_outbox_overflow_and_ttl_drops_are_counted(monkeypatch):
    monkeypatch.setenv("P2P_OUTBOX_MAX", "2")
    monkeypatch.setenv("P2P_OUTBOX_TTL_S", "0.2")
    directory = DirectoryService(addr="127.0.0.1:0").start()
    a = _node("najy", directory.url)
    b = _node("cannan", directory.url)
    try:
        _send(a, "cannan", "warmup")
        _wait_inbox(b, 1)
        b.stop()
        for i in range(3):
            assert _send(a, "cannan", f"m{i}")[1]["status"] == "queued"
        deadline = time.monotonic() + 8
        while _metric(a, 'p2p_messages_dropped_total{reason="ttl"}') != 2:
            assert time.monotonic() < deadline, "never expired"
            time.sleep(0.1)
        assert _metric(
            a, 'p2p_messages_dropped_total{reason="overflow"}') == 1
        assert _metric(a, "p2p_outbox_depth") == 0
        # stop() deregistered B: the directory no longer resolves it.
        status, _ = http_json("GET", f"{directory.url}/lookup?username="
                              "cannan", raise_for_status=False)
        assert status == 404
    finally:
        a.stop()
        directory.stop()


@pytest.mark.parametrize("site", ["p2p.node.deliver", "p2p.node.resolve"])
def test_delivery_failpoints_queue_then_recover(site, pair):
    directory, a, b = pair
    _send(a, "cannan", "warmup")
    _wait_inbox(b, 1)
    fp.arm(site, "raise")
    if site == "p2p.node.resolve":      # the direct path must fail too
        fp.arm("p2p.node.deliver", "raise")
    assert _send(a, "cannan", "delayed")[1]["status"] == "queued"
    if site == "p2p.node.resolve":
        fp.disarm("p2p.node.deliver")
        time.sleep(0.6)                 # worker rounds tick; resolve armed
        assert len(http_json("GET", f"{b.http_url}/inbox")[1]) == 1
    assert fp.hits(site) >= 1
    fp.disarm(site)
    assert [m["content"] for m in _wait_inbox(b, 2, 15.0)] == [
        "warmup", "delayed"]


class _FakeGateway:
    """RFC 6886 responder: opcode 0 (external address) and 1/2 (map,
    lifetime 0 deletes); ``error_code`` forces a result, ``drop_first``
    loses the first requests."""

    def __init__(self, error_code=0, drop_first=0, offset=0):
        self.error_code, self.drop_first, self.offset = (
            error_code, drop_first, offset)
        self.external_ip = "203.0.113.7"
        self.mappings, self.requests = {}, 0
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.addr = self.sock.getsockname()
        threading.Thread(target=self._serve, daemon=True).start()

    def close(self):
        self.sock.close()

    def _serve(self):
        try:
            while True:
                self._answer(*self.sock.recvfrom(64))
        except OSError:             # closed
            return

    def _answer(self, data, src):
        self.requests += 1
        if self.requests <= self.drop_first or data[:1] != b"\x00":
            return
        op = data[1]
        if op == 0:
            self.sock.sendto(struct.pack(
                "!BBHI", 0, 128, self.error_code, 1)
                + socket.inet_aton(self.external_ip), src)
        elif op in (1, 2):
            _, _, _, iport, eport, life = struct.unpack_from(
                "!BBHHHI", data)
            if life == 0:
                self.mappings.pop((op, iport), None)
                ext = 0
            else:
                ext = self.mappings.get((op, iport), (
                    (eport or iport) + self.offset, 0))[0]
                self.mappings[(op, iport)] = (ext, life)
            self.sock.sendto(struct.pack(
                "!BBHIHHI", 0, 128 + op, self.error_code, 1, iport, ext,
                life), src)


def test_natpmp_client_against_a_fake_gateway():
    gw = _FakeGateway(drop_first=1, offset=1000)
    try:
        c = NatPmpClient(gw.addr[0], gw.addr[1], first_rto_s=0.1, tries=3)
        assert c.external_address() == "203.0.113.7"
        assert gw.requests >= 2                 # one retransmit
        m = c.map_port(PROTO_TCP, 4001, 4001, lifetime_s=600)
        assert (m.external_port, m.lifetime_s) == (5001, 600)
        c.unmap(PROTO_TCP, 4001)
        assert (2, 4001) not in gw.mappings
        mapper = PortMapper(4500, gateway=gw.addr[0], port=gw.addr[1],
                            lifetime_s=1)
        assert mapper.acquire() == ("203.0.113.7", 5500)
        before = gw.requests
        assert mapper.renew_if_due() is None and gw.requests == before
        time.sleep(0.6)
        mapper.renew_if_due()
        assert gw.requests > before
        mapper.release()
        assert (2, 4500) not in gw.mappings
    finally:
        gw.close()
    bad = _FakeGateway(error_code=2)
    try:
        with pytest.raises(NatPmpError) as e:
            NatPmpClient(bad.addr[0], bad.addr[1], first_rto_s=0.05,
                         tries=2).external_address()
        assert e.value.result_code == 2
    finally:
        bad.close()
    with pytest.raises(NatPmpUnavailable):
        NatPmpClient("127.0.0.1", bad.addr[1], first_rto_s=0.05,
                     tries=2).external_address()


def test_node_advertises_and_releases_a_mapped_addr():
    gw = _FakeGateway()
    directory = DirectoryService(addr="127.0.0.1:0").start()
    n = ChatNode(username="najy", http_addr="127.0.0.1:0",
                 directory_url=directory.url, bootstrap_addrs="",
                 relay_addrs="", identity_file="", dht_addr="off")
    n._natpmp_enabled = True
    n._natpmp_gateway = "%s:%d" % gw.addr
    n.start()
    want = f"/ip4/203.0.113.7/tcp/{n.host.listen_port}/p2p/{n.host.peer_id}"
    try:
        deadline = time.monotonic() + 5
        while want not in n.dir.lookup("najy").addrs:
            assert time.monotonic() < deadline, "never advertised"
            time.sleep(0.05)
        assert want in http_json("GET", f"{n.http_url}/me")[1]["addrs"]
    finally:
        n.stop()
        directory.stop()
        gw.close()
    assert (2, n.host.listen_port) not in gw.mappings


def _spawn(module, env, log):
    return subprocess.Popen([sys.executable, "-m", module], cwd=ROOT,
                            env=env, stdout=log, stderr=subprocess.STDOUT)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_points_run_as_processes_that_see_no_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", NATPMP="0", DHT_ADDR="off",
               P2P_HOLEPUNCH="0")
    dport, aport, bport = _free_port(), _free_port(), _free_port()
    addr_file = str(tmp_path / "relay.addr")
    procs, logs = [], []

    def spawn(name, module, **kw):
        log = open(tmp_path / f"{name}.log", "wb")
        logs.append(log)
        procs.append(_spawn(module, dict(env, **kw), log))
    try:
        spawn("dir", "p2p_llm_chat_tpu_torch.directory",
              ADDR=f"127.0.0.1:{dport}")
        spawn("relay", "p2p_llm_chat_tpu_torch.relay",
              RELAY_ADDR="127.0.0.1:0", RELAY_ADDR_FILE=addr_file)
        deadline = time.monotonic() + 60
        while not os.path.exists(addr_file):
            assert time.monotonic() < deadline, "the relay never started"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.05)
        with open(addr_file) as f:
            relay_addr = f.read().strip()
        common = dict(DIRECTORY_URL=f"http://127.0.0.1:{dport}")
        spawn("a", "p2p_llm_chat_tpu_torch.node", MYNAMEIS="najy",
              HTTP_ADDR=f"127.0.0.1:{aport}", **common)
        spawn("b", "p2p_llm_chat_tpu_torch.node", MYNAMEIS="cannan",
              HTTP_ADDR=f"127.0.0.1:{bport}", RELAY_ADDRS=relay_addr,
              IDENTITY_FILE=str(tmp_path / "b.key"), **common)
        deadline = time.monotonic() + 60
        for port in (aport, bport):
            while True:
                try:
                    http_json("GET", f"http://127.0.0.1:{port}/me",
                              timeout=2.0)
                    break
                except (ConnectionError, HttpError, OSError):
                    assert time.monotonic() < deadline, "a node never came up"
                    assert all(p.poll() is None for p in procs)
                    time.sleep(0.1)
        _, me = http_json("GET", f"http://127.0.0.1:{bport}/me")
        assert any("/p2p-circuit/" in x for x in me["addrs"])
        with open(tmp_path / "b.key", "rb") as f:
            assert len(f.read()) == 32
        _, resp = http_json("POST", f"http://127.0.0.1:{aport}/send",
                            {"to_username": "cannan", "content": "hi"},
                            timeout=20.0)
        assert resp["status"] == "sent"
        _, inbox = http_json("GET", f"http://127.0.0.1:{bport}/inbox")
        assert [m["content"] for m in inbox] == ["hi"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for log in logs:
            log.close()
    text = (tmp_path / "a.log").read_text()
    assert "registered najy" in text and "Traceback" not in text
