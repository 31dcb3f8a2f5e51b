"""The port's launcher (``python -m p2p_llm_chat_tpu_torch.start_all``),
the twin of tests/test_launcher.py, on the CPU with the fake backend.

- The full stack with ``--relay``: directory, serve, relay, 2 nodes and
  2 UIs boot; the relay is wired into both nodes (a circuit addr each)
  and so is the DHT; a ``/send`` lands in the peer's inbox; the co-pilot
  answers through the UI; SIGINT leaves no process of the launcher's
  tree alive.
- ``--replicas 2``: two replica serve children and the port's router on
  the main serve port; both replicas turn ready and a generate answers
  through the router; SIGTERM ends the tree.

Every port handed to the launcher is reserved first, ``node0 + i`` and
``ui0 + i`` included (the launcher binds ``base + index``): each test
finds consecutive free blocks and holds them bound until the launcher
starts. Each launcher runs in a session of its own, joined with a
timeout and killed as a group if it outlives it.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = [sys.executable, "-m", "p2p_llm_chat_tpu_torch.start_all"]


def _reserve_blocks(*sizes):
    """One block of ``size`` consecutive free loopback ports per size,
    each port bound (held) by a socket: (bases, sockets). Close the
    sockets just before handing the ports on."""
    socks, bases = [], []
    for size in sizes:
        for _ in range(200):
            probe = socket.socket()
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
            probe.close()
            held = []
            try:
                for off in range(size):
                    s = socket.socket()
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    held.append(s)
                    s.bind(("127.0.0.1", base + off))
            except OSError:
                for s in held:
                    s.close()
                continue
            socks += held
            bases.append(base)
            break
        else:
            raise AssertionError(f"no block of {size} free ports")
    return bases, socks


def _release(socks):
    for s in socks:
        s.close()


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post(url, body, timeout=20):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _launch(args, socks):
    env = dict(os.environ, SERVE_BACKEND="fake", CUDA_VISIBLE_DEVICES="",
               NATPMP="0")
    env.pop("FAIL_POINTS", None)
    _release(socks)
    return subprocess.Popen(LAUNCHER + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _group_alive(pgid) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


def _end(p, sig, timeout=30.0):
    """Signal the launcher, join it with a timeout, then kill whatever of
    its tree remains. Returns (launcher exited in time, tree gone)."""
    pgid = p.pid
    if p.poll() is None:
        p.send_signal(sig)
    try:
        p.wait(timeout=timeout)
        exited = True
    except subprocess.TimeoutExpired:
        exited = False
    deadline = time.monotonic() + 10.0
    while _group_alive(pgid) and time.monotonic() < deadline:
        time.sleep(0.2)
    gone = not _group_alive(pgid)
    if not gone or not exited:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait(timeout=10)
    return exited, gone


def _wait(p, ready, deadline_s=90.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        try:
            ready()
            return
        except Exception:
            assert p.poll() is None, (
                "launcher died during startup: "
                + p.stdout.read().decode(errors="replace")[-2000:])
            time.sleep(0.5)
    raise AssertionError("stack never became ready")


def test_start_all_full_stack_roundtrip():
    pytest.importorskip("cryptography")
    (dirp, servep, relayp, node0, ui0), socks = _reserve_blocks(1, 1, 1, 2, 2)
    node1, ui1 = node0 + 1, ui0 + 1
    p = _launch(["--relay", "--node-port-base", str(node0),
                 "--ui-port-base", str(ui0), "--dir-port", str(dirp),
                 "--serve-port", str(servep), "--relay-port", str(relayp)],
                socks)
    try:
        def ready():
            _get(f"http://127.0.0.1:{node1}/me", timeout=1)
            urllib.request.urlopen(f"http://127.0.0.1:{ui1}/", timeout=1)
        _wait(p, ready)
        # The relay and the DHT are wired into both nodes.
        for port in (node0, node1):
            me = _get(f"http://127.0.0.1:{port}/me")
            assert any("/p2p-circuit/" in a for a in me["addrs"]), me
            assert me.get("dht_addr"), me
        # The serve child is the port's entry.
        with open(f"/proc/{p.pid}/task/{p.pid}/children") as f:
            kids = f.read().split()
        cmds = []
        for k in kids:
            with open(f"/proc/{k}/cmdline", "rb") as f:
                cmds.append(f.read().split(b"\0"))
        mods = {c[2].decode() for c in cmds if len(c) > 2 and c[1] == b"-m"}
        assert mods == {f"p2p_llm_chat_tpu_torch.{m}" for m in
                        ("directory", "serve", "relay", "node", "ui")}, mods

        r = _post(f"http://127.0.0.1:{node0}/send",
                  {"to_username": "Cannan", "content": "launcher e2e"})
        assert r["status"] == "sent"
        deadline = time.time() + 15
        inbox = []
        while time.time() < deadline:
            inbox = _get(f"http://127.0.0.1:{node1}/inbox?after=")
            if inbox:
                break
            time.sleep(0.3)
        assert any(m["content"] == "launcher e2e" for m in inbox), inbox

        sug = _post(f"http://127.0.0.1:{ui1}/api/suggest",
                    {"content": "launcher e2e"})
        assert isinstance(sug.get("suggestion"), str) and sug["suggestion"]
    finally:
        exited, gone = _end(p, signal.SIGINT)
    assert exited, "launcher did not exit on SIGINT"
    assert gone, "a child of the launcher outlived SIGINT"
    with pytest.raises(Exception):
        _get(f"http://127.0.0.1:{node0}/me", timeout=2)


def test_start_all_replica_router_mode():
    """``--replicas 2``: replicas on serve_port + 1 and + 2 (the block of
    three is reserved), the router on serve_port; no users."""
    (dirp, node0, ui0, servep), socks = _reserve_blocks(1, 1, 1, 3)
    p = _launch(["--replicas", "2", "--users", "",
                 "--node-port-base", str(node0), "--ui-port-base", str(ui0),
                 "--dir-port", str(dirp), "--serve-port", str(servep)],
                socks)
    try:
        url = f"http://127.0.0.1:{servep}"
        _wait(p, lambda: _get(f"{url}/readyz", timeout=1))
        deadline = time.time() + 60
        reps = _get(f"{url}/admin/replicas")["replicas"]
        assert len(reps) == 2, reps
        while (time.time() < deadline
               and not all(r["ready"] for r in reps)):
            time.sleep(0.5)
            reps = _get(f"{url}/admin/replicas")["replicas"]
        assert all(r["ready"] for r in reps), reps
        assert sorted(r["url"] for r in reps) == [
            f"http://127.0.0.1:{servep + 1}", f"http://127.0.0.1:{servep + 2}"]
        body = _post(f"{url}/api/generate", {
            "model": "fake-llm", "prompt": "replica launcher\n\nReply:",
            "stream": False})
        assert body["done"] is True and "replica launcher" in body["response"]
    finally:
        exited, gone = _end(p, signal.SIGTERM)
    assert exited, "launcher did not exit on SIGTERM"
    assert gone, "a child of the launcher outlived SIGTERM"
