"""The port's serve entry in router mode (``SERVE_ROUTER_UPSTREAMS``) and
the router's process spawners, on the CPU.

- ``SERVE_ROUTER_UPSTREAMS`` with ``SERVE_COORDINATOR`` is the
  reference's boot error, word for word.
- ``python -m p2p_llm_chat_tpu_torch.serve`` with
  ``SERVE_ROUTER_UPSTREAMS`` over two port FakeLLM fronts answers, reports
  a fleet ``/readyz`` and ``/metrics``, and exits 0 on SIGTERM.
- ``SERVE_ROUTER_AUTOSCALE=1 SERVE_BACKEND=fake``: under sustained
  pressure the router spawns ``python -m p2p_llm_chat_tpu_torch.serve``
  (the child's command line read from /proc), which joins the fleet;
  when the fleet idles it retires the child through drain and reaps it.
  With ``SERVE_PREFILL_REPLICAS=1`` the class autoscaler spawns a child
  tagged ``SERVE_REPLICA_CLASS=prefill``, and SIGTERM on the router
  reaps it and exits 0.

Every process started here runs with ``OMP_NUM_THREADS=1`` and is
joined with a timeout, then killed.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from p2p_llm_chat_tpu.serve import api as ref_api
from p2p_llm_chat_tpu_torch.serve import api
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.backend import FakeLLM

ROOT = pathlib.Path(__file__).resolve().parent.parent


class DepthLLM(FakeLLM):
    """A replica whose scraped queue depth the test sets."""

    def __init__(self, depth: float) -> None:
        super().__init__(name="rep")
        self.depth = depth

    def metrics_snapshot(self):
        return {"serve_queue_depth": self.depth}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_range(width: int) -> int:
    """A base port with ``width`` free ports above it."""
    for _ in range(50):
        base = _free_port()
        if base + width >= 65535:
            continue
        try:
            socks = []
            for p in range(base, base + width):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def _get(url: str, timeout: float = 5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()


def _wait(fn, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = fn()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _router_proc(env_extra: dict, log: pathlib.Path
                 ) -> tuple[subprocess.Popen, str]:
    """The port's entry in router mode, its output (and its spawned
    replicas') into ``log``."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SERVE_", "FAIL_POINTS"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", SERVE_ADDR=f"127.0.0.1:{port}",
               SERVE_ROUTER_SCRAPE_MS="100", **env_extra)
    with open(log, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"],
            cwd=str(ROOT), env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}"


def _end(proc: subprocess.Popen, log: pathlib.Path,
         timeout: float = 30.0) -> tuple[int, str]:
    """SIGTERM, join with a timeout, kill if it outlives it; the exit
    code and the output."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
    return proc.returncode, log.read_text(errors="replace")


def _children(pid: int) -> list[int]:
    got = []
    for task in pathlib.Path(f"/proc/{pid}/task").glob("*"):
        try:
            got += [int(c) for c in (task / "children").read_text().split()]
        except OSError:
            pass
    return got


def _cmdline(pid: int) -> list[str]:
    return pathlib.Path(f"/proc/{pid}/cmdline").read_bytes().decode() \
        .split("\0")[:-1]


def _gone(pid: int) -> bool:
    """Exited and reaped (a zombie still has a /proc entry)."""
    return not pathlib.Path(f"/proc/{pid}").exists()


def test_router_and_coordinator_together_is_the_reference_boot_error(
        monkeypatch):
    monkeypatch.setenv("SERVE_ROUTER_UPSTREAMS", "http://127.0.0.1:9")
    monkeypatch.setenv("SERVE_COORDINATOR", "127.0.0.1:9")
    with pytest.raises(SystemExit) as want:
        ref_api.main()
    with pytest.raises(SystemExit) as got:
        api.main()
    assert str(got.value) == str(want.value)
    assert "mutually exclusive" in str(got.value)


def test_router_entry_over_two_fronts_answers_and_exits_on_sigterm(
        tmp_path):
    fronts = [OllamaServer(FakeLLM(name="rep"), addr="127.0.0.1:0").start()
              for _ in range(2)]
    log = tmp_path / "router.log"
    proc, url = _router_proc({"SERVE_ROUTER_UPSTREAMS":
                              ",".join(f.url for f in fronts)}, log)
    try:
        _wait(lambda: _get(url + "/readyz")[0] == 200, 60, "fleet ready")
        for i in range(4):
            req = urllib.request.Request(
                url + "/api/generate",
                data=json.dumps({"model": "rep", "prompt": f"hello {i}",
                                 "stream": False}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert f"hello {i}" in json.loads(r.read())["response"]
        status, text = _get(url + "/metrics")
        assert status == 200
        assert "router_requests_total 4.0" in text
        assert 'serve_requests_total{replica="1"}' in text
        replicas = json.loads(_get(url + "/admin/replicas")[1])["replicas"]
        assert [r["url"] for r in replicas] == [f.url for f in fronts]
        assert sum(r["routed"] for r in replicas) == 4
    finally:
        rc, out = _end(proc, log)
        for f in fronts:
            f.stop()
    assert rc == 0, out[-3000:]
    assert "replica router on" in out


def test_autoscaler_spawns_port_entry_and_retires_it_through_drain(
        tmp_path):
    base = DepthLLM(depth=50.0)
    log = tmp_path / "router.log"
    front = OllamaServer(base, addr="127.0.0.1:0").start()
    port_base = _free_range(4)
    proc, url = _router_proc({
        "SERVE_ROUTER_UPSTREAMS": front.url, "SERVE_BACKEND": "fake",
        "SERVE_ROUTER_AUTOSCALE": "1", "SERVE_ROUTER_AUTOSCALE_MIN": "1",
        "SERVE_ROUTER_AUTOSCALE_MAX": "2",
        "SERVE_ROUTER_AUTOSCALE_SUSTAIN": "2",
        "SERVE_ROUTER_AUTOSCALE_PORT_BASE": str(port_base)}, log)
    child = None
    try:
        child = _wait(lambda: (_children(proc.pid) or [None])[0], 60,
                      "a spawned replica")
        cmd = _cmdline(child)
        assert cmd[1:] == ["-m", "p2p_llm_chat_tpu_torch.serve"], cmd
        child_url = f"http://127.0.0.1:{port_base}"

        def joined():
            reps = json.loads(_get(url + "/admin/replicas")[1])["replicas"]
            return [r for r in reps if r["url"] == child_url and r["ready"]]
        _wait(joined, 60, "the spawned replica to join ready")
        assert "router_autoscale_up_total 1.0" in _get(url + "/metrics")[1]
        base.depth = 0.0              # the fleet idles: retire the spawn

        def retired():
            reps = json.loads(_get(url + "/admin/replicas")[1])["replicas"]
            return [r["url"] for r in reps] == [front.url]
        _wait(retired, 60, "the spawned replica to retire")
        _wait(lambda: _gone(child), 30, "the retired replica to be reaped")
        assert "router_autoscale_down_total 1.0" in _get(url + "/metrics")[1]
    finally:
        rc, out = _end(proc, log)
        front.stop()
        if child is not None and not _gone(child):
            os.kill(child, signal.SIGKILL)
    assert rc == 0, out[-3000:]
    assert "autoscaler armed" in out and "drain" in out


def test_class_autoscaler_tags_spawns_and_sigterm_reaps_them(tmp_path):
    base = DepthLLM(depth=50.0)
    log = tmp_path / "router.log"
    front = OllamaServer(base, addr="127.0.0.1:0",
                         replica_class="prefill").start()
    port_base = _free_range(16)
    proc, url = _router_proc({
        "SERVE_ROUTER_UPSTREAMS": front.url, "SERVE_BACKEND": "fake",
        "SERVE_ROUTER_AUTOSCALE": "1", "SERVE_PREFILL_REPLICAS": "1",
        "SERVE_ROUTER_AUTOSCALE_MAX": "2",
        "SERVE_ROUTER_AUTOSCALE_SUSTAIN": "2",
        "SERVE_ROUTER_AUTOSCALE_PORT_BASE": str(port_base)}, log)
    child = None
    try:
        child = _wait(lambda: (_children(proc.pid) or [None])[0], 60,
                      "a spawned prefill replica")
        assert _cmdline(child)[1:] == ["-m", "p2p_llm_chat_tpu_torch.serve"]
        environ = pathlib.Path(f"/proc/{child}/environ").read_bytes()
        assert b"SERVE_REPLICA_CLASS=prefill\0" in environ
        child_url = f"http://127.0.0.1:{port_base}"
        ready = _wait(lambda: _get(child_url + "/readyz")[0] == 200
                      and json.loads(_get(child_url + "/readyz")[1]), 60,
                      "the prefill spawn's /readyz")
        assert ready["class"] == "prefill"
        text = _get(url + "/metrics")[1]
        assert "router_autoscale_up_total 1.0" in text
    finally:
        rc, out = _end(proc, log)
        front.stop()
        # SIGTERM on the router reaped its spawn before the router exited.
        outlived = child is not None and not _gone(child)
        if outlived:
            os.kill(child, signal.SIGKILL)
    assert rc == 0, out[-3000:]
    assert "per-class autoscaler armed" in out
    assert not outlived, "the spawned replica outlived its router"


_IMPORT_ROUTER = """
import json, sys
import p2p_llm_chat_tpu_torch.serve.router as router
import p2p_llm_chat_tpu_torch.serve.disagg
import torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                    "p2p_llm_chat_tpu"))
print(json.dumps({"bad": bad, "cuda": torch.cuda.is_initialized(),
                  "router_imports_torch": "torch" in vars(router)}))
"""


def test_importing_the_router_loads_no_jax_no_reference_no_cuda():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ROUTER], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "cuda": False, "router_imports_torch": False}
