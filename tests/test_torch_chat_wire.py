"""Mixed fleets over loopback: the port's chat plane against the
reference's on the wire. Hosts handshake both ways (and refuse a wrong
peer id on both sides), handshake transcripts and frames are the same
bytes, nodes of either package exchange messages through either
package's directory, circuits run through either package's relay, and
DHT records resolve across packages."""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

import p2p_llm_chat_tpu.directory as ref_directory
import p2p_llm_chat_tpu.node as ref_node
import p2p_llm_chat_tpu.p2p.dht as ref_dht
import p2p_llm_chat_tpu.p2p.identity as ref_identity
import p2p_llm_chat_tpu.p2p.transport as ref_transport
import p2p_llm_chat_tpu.relay as ref_relay
import p2p_llm_chat_tpu_torch.directory as port_directory
import p2p_llm_chat_tpu_torch.node as port_node
import p2p_llm_chat_tpu_torch.p2p.dht as port_dht
import p2p_llm_chat_tpu_torch.p2p.identity as port_identity
import p2p_llm_chat_tpu_torch.p2p.transport as port_transport
import p2p_llm_chat_tpu_torch.relay as port_relay
from p2p_llm_chat_tpu_torch.p2p.addr import Multiaddr
from p2p_llm_chat_tpu_torch.utils.http import http_json

PKG = {
    "ref": dict(transport=ref_transport, dht=ref_dht, node=ref_node,
                directory=ref_directory, relay=ref_relay,
                identity=ref_identity),
    "port": dict(transport=port_transport, dht=port_dht, node=port_node,
                 directory=port_directory, relay=port_relay,
                 identity=port_identity),
}
CROSS = [("port", "ref"), ("ref", "port")]
ALL4 = [("ref", "ref"), ("port", "ref"), ("ref", "port"), ("port", "port")]
ECHO = "/echo/1.0.0"


def _key(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=32, dtype=np.uint8).tobytes()


def _identity(pkg: str, seed: int):
    i = PKG[pkg]["identity"]
    return i.Identity(i.Ed25519PrivateKey.from_private_bytes(_key(seed)))


def _wait(cond, what: str, timeout: float = 5.0):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _echo_host(pkg: str, seed: int, seen: list):
    t = PKG[pkg]["transport"]
    host = t.P2PHost(identity=_identity(pkg, seed))

    def echo(stream, remote_peer_id):
        try:
            data = stream.recv_frame()
            seen.append(remote_peer_id)
            stream.send_frame(data.upper())
        finally:
            stream.close()
    host.set_stream_handler(ECHO, echo)
    return host.start()


@pytest.mark.parametrize("dialer,listener", CROSS)
def test_hosts_handshake_across_packages(dialer, listener):
    seen: list = []
    lst = _echo_host(listener, 1, seen)
    dia = PKG[dialer]["transport"].P2PHost(identity=_identity(dialer, 2))
    try:
        addr = Multiaddr.parse(str(lst.addrs()[0]))
        assert addr.peer_id == lst.peer_id
        stream = dia.new_stream(addr, ECHO, timeout=5.0)
        try:
            stream.settimeout(5.0)
            stream.send_frame(b"ping across packages")
            stream.close_write()
            assert stream.recv_frame() == b"PING ACROSS PACKAGES"
            assert stream.remote_peer_id == lst.peer_id
        finally:
            stream.close()
        assert _wait(lambda: seen, "the listener's handler") == [dia.peer_id]
    finally:
        dia.close()
        lst.close()


@pytest.mark.parametrize("dialer,listener", CROSS)
def test_wrong_peer_id_fails_on_both_sides(dialer, listener, monkeypatch):
    lt = PKG[listener]["transport"]
    failures: list = []
    real = lt.listener_handshake

    def recording(*a, **k):
        try:
            return real(*a, **k)
        except Exception as e:
            failures.append(e)
            raise
    monkeypatch.setattr(lt, "listener_handshake", recording)
    seen: list = []
    lst = _echo_host(listener, 3, seen)
    dia = PKG[dialer]["transport"].P2PHost(identity=_identity(dialer, 4))
    try:
        wrong = _identity("port", 5).peer_id
        addr = Multiaddr("127.0.0.1", lst.listen_port, peer_id=wrong)
        with pytest.raises(PKG[dialer]["transport"].HandshakeError,
                           match="peer identity mismatch"):
            dia.new_stream(addr, ECHO, timeout=5.0)
        err = _wait(lambda: failures, "the listener's handshake to fail")
        assert isinstance(err[0], (lt.HandshakeError, OSError)), err
        assert seen == []
    finally:
        dia.close()
        lst.close()


class _Recorder:
    """A socket that keeps every byte it sends."""

    def __init__(self, sock):
        self.sock = sock
        self.sent = bytearray()

    def sendall(self, data):
        self.sent += data
        self.sock.sendall(data)

    def recv(self, n):
        return self.sock.recv(n)

    def settimeout(self, t):
        self.sock.settimeout(t)

    def shutdown(self, how):
        self.sock.shutdown(how)

    def close(self):
        self.sock.close()


class _FixedEphemerals:
    """Stands in for X25519PrivateKey in a transport module: ``generate``
    hands out fixed keys in order (the dialer's first, then the
    listener's), every other attribute is the real class's."""

    def __init__(self, real, raws):
        self.real = real
        self.raws = list(raws)

    def generate(self):
        raw = self.raws.pop(0)
        if hasattr(self.real, "from_private_bytes"):
            return self.real.from_private_bytes(raw)
        return self.real(int.from_bytes(raw, "big"))     # the dev stand-in

    def __getattr__(self, name):
        return getattr(self.real, name)


def _transcript(dialer: str, listener: str, monkeypatch) -> tuple:
    dt, lt = PKG[dialer]["transport"], PKG[listener]["transport"]
    fixed = _FixedEphemerals(port_transport.X25519PrivateKey,
                             [_key(10), _key(11)])
    monkeypatch.setattr(dt, "X25519PrivateKey", fixed)
    monkeypatch.setattr(lt, "X25519PrivateKey", fixed)
    a, b = socket.socketpair()
    ra, rb = _Recorder(a), _Recorder(b)
    out: dict = {}

    def listen():
        try:
            out["stream"] = lt.listener_handshake(rb, _identity(listener, 21))
        except Exception as e:       # noqa: BLE001 — reported below
            out["error"] = e
    th = threading.Thread(target=listen, daemon=True)
    th.start()
    try:
        d = dt.dialer_handshake(ra, _identity(dialer, 20),
                                _identity(listener, 21).peer_id)
        th.join(5.0)
        assert not th.is_alive() and "error" not in out, out
        lstream = out["stream"]
        assert lstream.remote_peer_id == _identity(dialer, 20).peer_id
        d.settimeout(5.0)
        lstream.settimeout(5.0)
        d.send_frame(b"/p2p-llm-chat/1.0.0")
        d.send_frame(b'{"content": "hi"}')
        assert lstream.recv_frame() == b"/p2p-llm-chat/1.0.0"
        assert lstream.recv_frame() == b'{"content": "hi"}'
        lstream.send_frame(b'{"ack": "m1"}')
        assert d.recv_frame() == b'{"ack": "m1"}'
        return bytes(ra.sent), bytes(rb.sent)
    finally:
        a.close()
        b.close()
        monkeypatch.undo()


def test_handshake_transcripts_and_frames_are_the_same_bytes(monkeypatch):
    got = {pair: _transcript(*pair, monkeypatch) for pair in ALL4}
    want = got[("ref", "ref")]
    # msg1 (32) and the dialer's frames; msg2 (32 + 32 + 64) and the ack.
    assert len(want[1]) == 4 + 128 + 4 + 13 + 16
    for pair, t in got.items():
        assert t == want, pair


@pytest.mark.parametrize("seed", [0, 1])
def test_signed_records_and_dht_datagrams_are_the_same_bytes(seed):
    addrs = ["/ip4/127.0.0.1/tcp/4001/p2p/x",
             "/ip4/1.2.3.4/tcp/4100/p2p/r/p2p-circuit/p2p/x"]
    recs = [PKG[p]["dht"].SignedRecord.create(_identity(p, seed), "najy",
                                              addrs, seq=1234 + seed)
            for p in ("ref", "port")]
    assert recs[0].to_wire() == recs[1].to_wire()
    key = port_dht.key_for_username("najy")
    assert key == ref_dht.key_for_username("najy")
    assert port_dht.SignedRecord.from_wire(recs[0].to_wire()).verify(key)
    assert ref_dht.SignedRecord.from_wire(recs[1].to_wire()).verify(key)
    bad = dict(recs[1].to_wire(), addrs=addrs[:1])
    assert not port_dht.SignedRecord.from_wire(bad).verify(key)
    msg = {"t": "put", "rid": "0123456789abcdef", "record": recs[0].to_wire(),
           "from": recs[0].peer_id}
    sent = []
    for p in ("ref", "port"):
        node = PKG[p]["dht"].DHTNode(_identity(p, seed), "127.0.0.1:0")
        try:
            real, captured = node.sock, []

            class _Sock:
                def sendto(self, data, dst):
                    captured.append(data)
            node.sock = _Sock()
            node._send(dict(msg), ("127.0.0.1", 9))
            node.sock = real
        finally:
            node.close()
        sent.append(captured[0])
    assert sent[0] == sent[1]
    for p in ("ref", "port"):
        assert PKG[p]["dht"]._verify_msg(json.loads(sent[0]))
    assert port_dht.parse_seeds("a:1, :2,bad, 127.0.0.1:3") == \
        ref_dht.parse_seeds("a:1, :2,bad, 127.0.0.1:3")


@pytest.mark.parametrize("writer,reader", CROSS)
def test_dht_resolves_a_record_stored_by_the_other_package(writer, reader):
    w = PKG[writer]["dht"].DHTNode(_identity(writer, 30)).start()
    r = PKG[reader]["dht"].DHTNode(_identity(reader, 31)).start()
    try:
        assert r.bootstrap([w.addr]) >= 1
        addrs = [f"/ip4/127.0.0.1/tcp/4001/p2p/{w.ident.peer_id}"]
        assert w.put_self_record("najy", addrs) >= 1
        rec = r.get_record("najy", budget_s=3.0)
        assert rec is not None
        assert rec.peer_id == w.ident.peer_id and rec.addrs == addrs
        assert rec.verify(port_dht.key_for_username("najy"))
        assert r.get_record("nobody", budget_s=1.0) is None
    finally:
        r.close()
        w.close()


def test_directories_answer_the_same_json():
    dirs = [PKG[p]["directory"].DirectoryService(addr="127.0.0.1:0").start()
            for p in ("ref", "port")]
    try:
        calls = [
            ("POST", "/register", {"username": "najy", "peer_id": "P1",
                                   "addrs": ["/ip4/127.0.0.1/tcp/1/p2p/P1"]}),
            ("POST", "/register", {"username": "x"}),
            ("POST", "/register", {"username": "x", "peer_id": "P",
                                   "addrs": [1]}),
            ("GET", "/lookup?username=najy", None),
            ("GET", "/lookup?username=nobody", None),
            ("GET", "/lookup", None),
            ("POST", "/deregister", {"username": "najy", "peer_id": "P2"}),
            ("GET", "/lookup?username=najy", None),
            ("POST", "/deregister", {"username": "najy", "peer_id": "P1"}),
            ("GET", "/lookup?username=najy", None),
            ("GET", "/healthz", None),
        ]
        for method, path, body in calls:
            got = [http_json(method, d.url + path, body,
                             raise_for_status=False, timeout=5.0)
                   for d in dirs]
            for g in got:
                if isinstance(g[1], dict):
                    g[1].pop("last", None)
            assert got[0] == got[1], (method, path)
        metrics = []
        for d in dirs:
            with urllib.request.urlopen(d.url + "/metrics", timeout=5.0) as r:
                metrics.append((r.status, r.headers["Content-Type"],
                                r.read()))
        assert metrics[0] == metrics[1]
        # Each package's client reads the other's service.
        for client_pkg, d in (("port", dirs[0]), ("ref", dirs[1])):
            c = PKG[client_pkg]["directory"].DirectoryClient(d.url)
            c.register("cannan", "P3", ["/ip4/127.0.0.1/tcp/2/p2p/P3"])
            rec = c.lookup("cannan")
            assert (rec.peer_id, rec.addrs) == (
                "P3", ["/ip4/127.0.0.1/tcp/2/p2p/P3"])
    finally:
        for d in dirs:
            d.stop()


def _node(pkg: str, name: str, directory_url: str, relay_addrs: str = ""):
    return PKG[pkg]["node"].ChatNode(
        username=name, http_addr="127.0.0.1:0", directory_url=directory_url,
        bootstrap_addrs="", relay_addrs=relay_addrs, identity_file="",
        dht_addr="off").start()


def _send(node, to: str, content: str) -> dict:
    status, resp = http_json("POST", f"{node.http_url}/send",
                             {"to_username": to, "content": content},
                             timeout=15.0)
    assert status == 200, resp
    return resp


def _inbox(node) -> list:
    return http_json("GET", f"{node.http_url}/inbox?after=", timeout=5.0)[1]


@pytest.mark.parametrize("dir_pkg", ["ref", "port"])
def test_port_and_reference_nodes_chat_through_either_directory(dir_pkg):
    d = PKG[dir_pkg]["directory"].DirectoryService(addr="127.0.0.1:0").start()
    a = _node("port", "najy", d.url)
    b = _node("ref", "cannan", d.url)
    try:
        assert _send(a, "cannan", "port to reference")["status"] == "sent"
        assert _send(b, "najy", "reference to port")["status"] == "sent"
        assert _send(a, "cannan", "again")["status"] == "sent"
        got_b = [m["content"] for m in _inbox(b)]
        got_a = _inbox(a)
        assert got_b == ["port to reference", "again"]
        assert [m["content"] for m in got_a] == ["reference to port"]
        assert got_a[0]["from_user"] == "cannan" and got_a[0]["msg_id"]
        me = http_json("GET", f"{a.http_url}/me", timeout=5.0)[1]
        assert me["peer_id"] == a.host.peer_id and me["username"] == "najy"
    finally:
        for s in (a, b, d):
            s.stop()


@pytest.mark.parametrize("relay_pkg,sender,receiver,punch", [
    ("port", "ref", "ref", False), ("ref", "port", "port", False),
    ("port", "port", "ref", False), ("ref", "ref", "port", False),
    ("port", "ref", "ref", True), ("ref", "port", "port", True)])
def test_circuits_through_either_relay(relay_pkg, sender, receiver, punch,
                                       monkeypatch):
    monkeypatch.setenv("P2P_HOLEPUNCH", "1" if punch else "0")
    relay = PKG[relay_pkg]["relay"].RelayService(addr="127.0.0.1:0").start()
    d = port_directory.DirectoryService(addr="127.0.0.1:0").start()
    b = _node(receiver, "cannan", d.url, relay_addrs=str(relay.addr()))
    a = _node(sender, "najy", d.url)
    try:
        _wait(lambda: b.host.peer_id in relay._reservations,
              "B's reservation on the relay")
        rec = a.dir.lookup("cannan")
        circuit = [x for x in rec.addrs if "/p2p-circuit/" in x]
        assert len(circuit) == 1
        a.dir.register("cannan", rec.peer_id, circuit)
        sent = _send(a, "cannan", "through the relay")
        assert sent["status"] == "sent"
        assert [m["content"] for m in _inbox(b)] == ["through the relay"]
        # A punched path bypasses the splice; a spliced one goes through it.
        assert (relay._n_spliced == 0) == punch
        if relay_pkg == "port" and not punch:
            assert relay.pump in ("native", "python")
        held = http_json("GET", f"{a.http_url}/admin/trace?id="
                         f"{sent['trace']}", timeout=5.0)[1]
        assert [s["meta"]["via"] for s in held["spans"]] == ["relay"]
    finally:
        for s in (a, b, d, relay):
            s.stop()


def test_port_relay_refuses_an_unreserved_target(monkeypatch):
    monkeypatch.setenv("P2P_HOLEPUNCH", "0")
    relay = port_relay.RelayService(addr="127.0.0.1:0").start()
    dia = ref_transport.P2PHost(identity=_identity("ref", 40))
    try:
        addr = relay.addr().with_peer(_identity("ref", 41).peer_id)
        addr = addr.circuit_via(relay.peer_id)
        with pytest.raises(ConnectionError, match="relay hop refused"):
            dia.dial(addr, timeout=3.0)
        assert relay._n_spliced == 0
    finally:
        dia.close()
        relay.stop()
