"""The port's lockstep multi-process plane (serve/multihost.py) on gloo
ranks on the CPU, against the JAX ``MultihostEngine`` built in this
process on a mesh of the same shape (the conftest's fake CPU devices),
on the reference's f32 quote weights (models/synth.quote_params) carried
across: every rank loads the numpy tree and takes its shard.

- meshes dp = 2 (two ranks), dp = 1 × tp = 2 (two ranks) and
  dp = 2 × tp = 2 (four ranks, where the tp groups are not the world);
- the leader serves the Ollama front; four concurrent ``/api/generate``
  requests (three greedy, one seeded at temperature 0.8) answer the JAX
  plane's texts, the ``serve_multihost_*`` gauges equal its (requests
  above rounds where dp = 2; the process count is the world's, where the
  in-process oracle counts one), and ``/api/embed`` vectors are within
  1e-4 of its;
- the env path: two ``python -m p2p_llm_chat_tpu_torch.serve`` processes
  (``SERVE_DEVICE=cpu SERVE_COORDINATOR=... MODEL_CONFIG=tiny``) answer
  over HTTP, and both exit 0 after SIGTERM to the leader;
- a fault planted in the follower's round ends the plane within the
  test's bound instead of hanging it: the follower leaves the world and
  exits non-zero, and the leader fails its requests, turns not ready and
  refuses new ones.

Every spawned rank has a time limit and is killed on the way out.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.llama import param_axes as ref_param_axes
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig, make_mesh
from p2p_llm_chat_tpu.parallel.sharding import shard_params
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest)
from p2p_llm_chat_tpu.serve.multihost import MultihostEngine as RefEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer

pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SEQ = 128
WINDOW_MS = 1500
EMBED_TOL = 1e-4
# (prompt, options): three greedy rows and one seeded sampled row, all
# under 31 bytes so every pairing of rows shares one prompt bucket.
REQS = [("abcabc hello", {"num_predict": 10}),
        ("the quick brown fox", {"num_predict": 10}),
        ("0123456789", {"num_predict": 10}),
        ("seeded: lunch at noon?", {"num_predict": 10, "temperature": 0.8,
                                    "top_p": 0.9, "seed": 42})]
EMBED_TEXTS = ["hi", "how are you?", "see you at noon"]
LIMIT_S = 60.0   # each test's spawned ranks, start to exit

_RANK = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.serve.api import OllamaServer
from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env

w = np.load(os.environ["WEIGHTS"])
tree = {}
for k in w.files:
    node = tree
    *path, leaf = k.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = torch.from_numpy(w[k])
eng = build_engine_from_env(params=tree)
if eng.is_follower:
    try:
        eng.follower_loop()
    finally:
        eng.close()
    sys.exit(0)
srv = OllamaServer(eng).start()
print("LEADER UP", flush=True)
sys.stdin.readline()
srv.stop()
eng.stop()
eng.close()
"""


_FAULT = r"""
import json, os, sys, threading
sys.path.insert(0, os.environ["REPO"])
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest)
from p2p_llm_chat_tpu_torch.serve.engine import build_engine_from_env

eng = build_engine_from_env()
if eng.is_follower:
    def planted(cmd):
        raise RuntimeError("planted fault")
    eng._run_cmd = planted
    try:
        eng.follower_loop()
    finally:
        eng.close()
    sys.exit(0)
errors = [None, None]


def gen(i, prompt):
    try:
        "".join(eng.generate_stream(GenerateRequest(
            prompt=prompt, options=GenerateOptions(max_tokens=8))))
    except RuntimeError as e:
        errors[i] = str(e)


ts = [threading.Thread(target=gen, args=(i, p))
      for i, p in enumerate(["first request", "second request"])]
for t in ts:
    t.start()
for t in ts:
    t.join(30)
out = dict(errors=errors, hung=[t.is_alive() for t in ts],
           ready=eng.ready())
try:
    eng.generate_stream(GenerateRequest(prompt="later"))
    out["later"] = None
except RuntimeError as e:
    out["later"] = str(e)
eng.stop()
eng.close()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _post(url: str, path: str, body: dict, timeout: float = 60):
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _metrics(url: str) -> dict:
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if line.startswith("serve_multihost") and len(parts) == 2:
            out[parts[0]] = float(parts[1])
    return out


def _left(deadline: float) -> float:
    return max(0.5, deadline - time.monotonic())


def _wait_up(url: str, procs, deadline: float):
    while time.monotonic() < deadline:
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(
                    f"rank died rc={p.returncode}:\n"
                    f"{p.stdout.read()[-3000:]}")
        try:
            with urllib.request.urlopen(f"{url}/api/version", timeout=2):
                return
        except OSError:
            time.sleep(0.3)
    raise AssertionError("the leader's front never came up")


def _spawn(n: int, env_extra: dict, code=None, stdin=None):
    port = _free_port()
    procs = []
    for pid in range(n):
        env = dict(os.environ, REPO=REPO, PYTHONPATH=REPO,
                   SERVE_BACKEND="torch", SERVE_DEVICE="cpu",
                   SERVE_COORDINATOR=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(pid),
                   MODEL_CONFIG="tiny", SERVE_MAX_SEQ=str(MAX_SEQ),
                   OMP_NUM_THREADS="1", **env_extra)
        cmd = ([sys.executable, "-c", code] if code else
               [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"])
        procs.append(subprocess.Popen(
            cmd, env=env, stdin=stdin if pid == 0 else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _reap(procs, deadline: float) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_left(deadline))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs


def _burst(url: str, deadline: float) -> list:
    """The four requests at once; each answer's text, in REQS order."""
    out = [None] * len(REQS)

    def go(i):
        prompt, opts = REQS[i]
        out[i] = _post(url, "/api/generate", {
            "model": "tiny", "prompt": prompt, "stream": False,
            "options": opts}, timeout=_left(deadline))
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(REQS))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=_left(deadline))
    assert all(not t.is_alive() for t in ts)
    return out


@pytest.fixture(scope="module")
def quote(tmp_path_factory):
    rcfg = ref_config("tiny")
    rparams = quote_params(rcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    path = tmp_path_factory.mktemp("mh") / "weights.npz"
    np.savez(path, **_flat(rparams))
    return rcfg, rparams, str(path)


def _reference(rcfg, rparams, dp: int, tp: int):
    """The JAX plane on a dp × tp mesh in this process: the four requests
    enqueued at once (pairs co-batch where dp = 2), then the embeds."""
    mesh = make_mesh(MeshConfig(dp=dp, tp=tp))
    params = shard_params(rparams, ref_param_axes(rcfg), mesh)
    eng = RefEngine(params, rcfg, RefByteTokenizer(rcfg.vocab_size), mesh,
                    max_seq=MAX_SEQ, window_ms=WINDOW_MS)
    try:
        gens = [eng.generate_stream(RefRequest(
            model="tiny", prompt=p, options=RefOptions.from_ollama(o)))
            for p, o in REQS]
        texts = ["".join(g) for g in gens]
        vecs, _ = eng.embed(EMBED_TEXTS)
        return texts, eng.metrics_snapshot(), np.asarray(vecs)
    finally:
        eng.stop()


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp2", "tp2", "dp2xtp2"])
def test_plane_answers_the_jax_planes_texts(quote, dp, tp):
    rcfg, rparams, weights = quote
    want_texts, want_metrics, want_vecs = _reference(rcfg, rparams, dp, tp)
    assert len(set(want_texts)) == len(REQS) and all(want_texts)

    serve_port = _free_port()
    url = f"http://127.0.0.1:{serve_port}"
    deadline = time.monotonic() + LIMIT_S
    procs = _spawn(dp * tp, {"SERVE_TP": str(tp), "WEIGHTS": weights,
                             "SERVE_ADDR": f"127.0.0.1:{serve_port}",
                             "SERVE_MH_WINDOW_MS": str(WINDOW_MS)},
                   code=_RANK, stdin=subprocess.PIPE)
    try:
        _wait_up(url, procs, deadline)
        answers = _burst(url, deadline)
        vecs = np.asarray(_post(url, "/api/embed",
                                {"model": "tiny",
                                 "input": EMBED_TEXTS})["embeddings"])
        metrics = _metrics(url)
        procs[0].stdin.write("stop\n")
        procs[0].stdin.flush()
    finally:
        outs = _reap(procs, deadline)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert [a["response"] for a in answers] == want_texts
    for key, v in want_metrics.items():
        if key == "serve_multihost_processes":
            assert metrics[key] == dp * tp       # the oracle is 1 process
        else:
            assert metrics[key] == v, key
    assert metrics["serve_multihost_rows"] == dp
    if dp == 2:
        assert (metrics["serve_multihost_requests"]
                > metrics["serve_multihost_batched_rounds"])
    assert vecs.shape == want_vecs.shape == (len(EMBED_TEXTS),
                                             rcfg.hidden_size)
    assert np.abs(vecs - want_vecs).max() <= EMBED_TOL
    # Every rank ran every round: the same count in each rank's summary.
    rounds = {json.loads(o.split("summary: ", 1)[1].splitlines()[0])[
        "rounds"] for o in outs}
    assert rounds == {len(REQS) // dp + -(-len(EMBED_TEXTS) // dp)}, rounds


def test_env_path_serves_and_exits_zero_on_sigterm():
    serve_port = _free_port()
    url = f"http://127.0.0.1:{serve_port}"
    deadline = time.monotonic() + LIMIT_S
    procs = _spawn(2, {"SERVE_ADDR": f"127.0.0.1:{serve_port}",
                       "SERVE_MH_WINDOW_MS": "50"})
    try:
        _wait_up(url, procs, deadline)
        r = _post(url, "/api/generate", {"model": "tiny", "prompt": "hi",
                                         "stream": False,
                                         "options": {"num_predict": 4}})
        assert r["done"] is True and r["eval_count"] >= 1
        e = _post(url, "/api/embed", {"model": "tiny", "input": ["hi"]})
        assert len(e["embeddings"][0]) == ref_config("tiny").hidden_size
        assert _metrics(url)["serve_multihost_processes"] == 2
        procs[0].send_signal(signal.SIGTERM)
    finally:
        outs = _reap(procs, deadline)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    assert "follower 1 shutting down" in outs[1]
    for o in outs:
        assert '"backend": "gloo"' in o.split("summary: ", 1)[1]


def test_a_failed_round_on_the_follower_ends_the_plane():
    deadline = time.monotonic() + LIMIT_S
    procs = _spawn(2, {"SERVE_MH_WINDOW_MS": "200"}, code=_FAULT)
    leader, follower = _reap(procs, deadline)
    assert procs[1].returncode != 0, follower[-4000:]
    assert "round failed; leaving the world" in follower
    assert "planted fault" in follower
    assert procs[0].returncode == 0, leader[-4000:]
    assert "the plane stops" in leader
    res = json.loads(leader.split("RESULT ", 1)[1].splitlines()[0])
    assert res["hung"] == [False, False]
    # Each request failed with the round's error (the peer left), or, if
    # it was queued behind the round, with the plane's.
    assert all(res["errors"]), res
    assert res["ready"] is False
    assert "plane stopped" in res["later"]
