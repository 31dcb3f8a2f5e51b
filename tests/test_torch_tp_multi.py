"""Several models on the same ``SERVE_TP`` ranks (``SERVE_MODELS`` under
tensor parallelism, serve/tp.py): one op stream for the plane, each op
naming its engine, on two gloo ranks on the CPU.

- Two tags, ``a = tiny-tp`` and ``b = tiny-moe``, int8 weights over an
  int8 paged pool, on the reference's f32 quote weights
  (models/synth.quote_params) carried across as numpy: every rank loads
  the trees and takes its shards. Greedy requests to both tags at once
  answer the texts of the JAX ``MultiBackend`` of two ``TPUEngine``s on
  a ``tp = 2`` mesh of the conftest's fake CPU devices, and each tag's
  token digests are equal on both ranks; each rank logs one summary line
  per tag and one line of launches.
- A fault planted in one tag's tick op on the follower ends the plane for
  both tags: the follower exits non-zero, both tags' requests fail,
  neither engine is ready and both refuse new requests.
- The env path, ``SERVE_DEVICE=cpu SERVE_TP=2 SERVE_MODELS=a=tiny-tp,
  b=tiny-moe python -m p2p_llm_chat_tpu_torch.serve``: ``/readyz`` is
  503 until both engines have warmed, both tags answer and an unknown tag
  gets the default's answer, ``/api/tags`` and ``/api/ps`` list both, the
  profiler server captures tag ``b``'s loop, and SIGTERM ends both ranks
  with rc 0, two summary lines each and no process left.
- The plane's op lock (serve/tp._FairLock) grants in the order it was
  asked for, and a wait on a loop from inside an op is refused.

Every spawned process has a time limit, a thread cap and a kill on the way
out.
"""

import gzip
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from p2p_llm_chat_tpu.parallel.mesh import make_mesh as ref_make_mesh
from p2p_llm_chat_tpu.parallel.sharding import shard_params as ref_shard
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.serve.multi import MultiBackend as RefMulti
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.serve import tp as tp_mod
from p2p_llm_chat_tpu_torch.serve.multi import MultiBackend

torch.set_num_threads(2)
pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0   # each spawned world, start to exit
CAP = {"OMP_NUM_THREADS": "1"}   # every spawned rank's thread cap

TAGS = {"a": "tiny-tp", "b": "tiny-moe"}
PROMPTS = {"a": ["tensor parallel", "serving check"],
           "b": ["mixture of experts", "third request"]}
ENGINE = dict(num_slots=2, max_seq=128, prefix_cache=False, prefill_chunk=0,
              kv_mode="paged", page_size=16, kv_quant=True)
MAX_NEW = 8

_HEAD = r"""
import json, os, sys, threading
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.quant import quantize_params
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh, sharding
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.serve.multi import MultiBackend
from p2p_llm_chat_tpu_torch.serve.tp import TPChannel
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

d = os.environ["DIR"]
spec = json.load(open(os.path.join(d, "spec.json")))
assert distributed.init_distributed(join_timeout_s=30)
m = distributed.multihost_mesh(mesh.MeshConfig(tp=2), "cpu")
rank = m.rank


def tree_of(path):
    w = np.load(path)
    tree = {}
    for k in w.files:
        node = tree
        *p, leaf = k.split("/")
        for x in p:
            node = node.setdefault(x, {})
        node[leaf] = torch.from_numpy(w[k])
    return tree


# Every rank builds the tags in spec order; the leader's engines share one
# channel, each under its position.
channel = TPChannel(m) if rank == 0 else None
engines = {}
for i, (tag, name) in enumerate(spec["tags"].items()):
    cfg = get_config(name)
    tree = quantize_params(tree_of(os.path.join(d, name + ".npz")),
                           mode="int8")
    engines[tag] = TorchEngine(
        sharding.shard_model(tree, cfg, m, "cpu"), cfg,
        ByteTokenizer(cfg.vocab_size), mesh=m, device="cpu", name=tag,
        tp_channel=channel, tp_index=i, **spec["engine"])
multi = MultiBackend(engines)


def gen(tag, prompt, n, out, key, started=None):
    try:
        parts = []
        for delta in multi.generate_stream(GenerateRequest(
                prompt=prompt, model=tag,
                options=GenerateOptions(max_tokens=n))):
            parts.append(delta)
            if started is not None:
                started.set()
        out[key] = "".join(parts)
    except RuntimeError as e:
        out[key] = "ERROR " + str(e)
"""

_RANK = _HEAD + r"""
res = {}
if multi.is_follower:
    multi.follower_loop()
else:
    texts = {}
    ts = [threading.Thread(target=gen, args=(tag, p, spec["max_new"], texts,
                                             f"{tag}/{i}"))
          for tag, ps in spec["prompts"].items() for i, p in enumerate(ps)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    res["texts"] = {tag: [texts[f"{tag}/{i}"] for i in range(len(ps))]
                    for tag, ps in spec["prompts"].items()}
    res["ready"] = multi.ready()
    multi.stop()
res["digests"] = {tag: e.scheduler.digests for tag, e in engines.items()}
res["lockstep"] = multi.lockstep
multi.close()
json.dump(res, open(os.path.join(d, f"rank{rank}.json"), "w"))
print("RANK DONE", rank, flush=True)
"""

_FAULT = _HEAD + r"""
if multi.is_follower:
    def planted(*args):
        raise RuntimeError("planted fault")
    engines["b"].scheduler._dev_tick = planted
    try:
        multi.follower_loop()
    finally:
        multi.close()
    sys.exit(0)
out = {}
began = threading.Event()
# Tag a's long request is decoding when tag b's first tick fails.
ta = threading.Thread(target=gen, args=("a", "tensor parallel", 100, out,
                                        "a", began))
ta.start()
began.wait(30)
tb = threading.Thread(target=gen, args=("b", "mixture of experts", 8, out,
                                        "b"))
tb.start()
for t in (ta, tb):
    t.join(30)
res = dict(errors=out, hung=[t.is_alive() for t in (ta, tb)],
           ready={tag: e.ready() for tag, e in engines.items()},
           multi_ready=multi.ready(), later={})
for tag in engines:
    try:
        multi.generate_stream(GenerateRequest(prompt="later", model=tag))
        res["later"][tag] = None
    except RuntimeError as e:
        res["later"][tag] = str(e)
multi.stop()
multi.close()
print("RESULT " + json.dumps(res), flush=True)
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


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def _spawn_world(d, code: str) -> list:
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, "-c", code], env=dict(
            os.environ, REPO=REPO, PYTHONPATH=REPO, DIR=str(d),
            SERVE_COORDINATOR=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid), SERVE_DEVICE="cpu", **CAP),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]


def _reap(procs) -> list:
    deadline = time.monotonic() + LIMIT_S
    try:
        return [p.communicate(timeout=max(0.5, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        _kill(procs)


@pytest.fixture(scope="module")
def quote(tmp_path_factory):
    """The reference's f32 quote trees (unfused) of both tags' configs,
    their npz files and the spec every rank reads."""
    d = tmp_path_factory.mktemp("tp_multi")
    trees = {}
    for name in TAGS.values():
        trees[name] = quote_params(ref_config(name), jax.random.PRNGKey(3),
                                   dtype=jnp.float32)
        np.savez(d / f"{name}.npz", **_flat(trees[name]))
    (d / "spec.json").write_text(json.dumps({
        "tags": TAGS, "prompts": PROMPTS, "engine": ENGINE,
        "max_new": MAX_NEW}))
    return d, trees


@pytest.fixture(scope="module")
def world(quote):
    """The two-tag world of two spawned ranks (started here, awaited by
    the first test that reads it): (each rank's results, each rank's
    log)."""
    d, _ = quote
    procs = _spawn_world(d, _RANK)
    done: dict = {}

    def results():
        if not done:
            outs = _reap(procs)
            for p, out in zip(procs, outs):
                assert p.returncode == 0, out[-4000:]
            done["ranks"] = [json.load(open(d / f"rank{r}.json"))
                             for r in range(2)]
            done["logs"] = outs
        return done["ranks"], done["logs"]
    try:
        yield results
    finally:
        _kill(procs)


@pytest.fixture(scope="module")
def ref_texts(quote):
    """The JAX multi-model front: one TPUEngine per tag on a tp = 2 mesh,
    every tag's prompts at once; {tag: texts}."""
    _, trees = quote
    mesh = ref_make_mesh(RefMeshConfig(tp=2), devices=jax.devices()[:2])
    engines = {}
    try:
        for tag, name in TAGS.items():
            rcfg = ref_config(name)
            fam = ref_mixtral if rcfg.is_moe else ref_llama
            params = ref_quant.quantize_params(
                ref_shard(trees[name], fam.param_axes(rcfg), mesh),
                mesh=mesh, mode="int8")
            engines[tag] = TPUEngine(params, rcfg,
                                     RefByteTokenizer(rcfg.vocab_size),
                                     mesh=mesh, name=tag, **ENGINE)
        multi = RefMulti(engines)
        out: dict = {}

        def go(tag, i, prompt):
            out[f"{tag}/{i}"] = "".join(multi.generate_stream(RefRequest(
                prompt=prompt, model=tag,
                options=RefOptions(max_tokens=MAX_NEW))))
        ts = [threading.Thread(target=go, args=(tag, i, p))
              for tag, ps in PROMPTS.items() for i, p in enumerate(ps)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        return {tag: [out[f"{tag}/{i}"] for i in range(len(ps))]
                for tag, ps in PROMPTS.items()}
    finally:
        for e in engines.values():
            e.stop()
        ref_quant.set_mm_impl("auto")


@pytest.mark.parametrize("tag", list(TAGS))
def test_each_tag_answers_the_jax_multi_fronts_texts(world, ref_texts, tag):
    want = ref_texts[tag]
    assert all(want) and len(set(want)) == len(want), want
    (r0, r1), _ = world()
    assert r0["texts"][tag] == want
    assert r0["ready"] is True and r0["lockstep"] and r1["lockstep"]
    d0, d1 = r0["digests"][tag], r1["digests"][tag]
    assert d0 == d1 and len(d0) == 2 and len(set(d0)) == 1, (d0, d1)


def test_each_rank_logs_one_summary_line_per_tag(world):
    ranks, logs = world()
    # The tags' digests differ: each engine folds its own tokens.
    assert ranks[0]["digests"]["a"] != ranks[0]["digests"]["b"]
    for rank, log in enumerate(logs):
        for tag in TAGS:
            line = log.split(f"tp rank {rank} model {tag} summary: ",
                             1)[1].splitlines()[0]
            s = json.loads(line)
            assert s["model"] == tag and s["digests_equal"] is True
            assert s["steps"] >= 1 and s["backend"] == "gloo"
        assert log.count("summary: ") == len(TAGS)
        assert log.count(f"tp rank {rank} launches: ") == 1
    assert "tp follower 1 shutting down" in logs[1]


def test_a_failed_op_of_one_tag_ends_the_plane_for_both(quote):
    d, _ = quote
    procs = _spawn_world(d, _FAULT)
    leader, follower = _reap(procs)
    assert procs[1].returncode != 0, follower[-4000:]
    assert "engine 1: op tick failed; leaving the world" in follower
    assert "planted fault" in follower
    assert procs[0].returncode == 0, leader[-4000:]
    assert "the plane stops" in leader
    res = json.loads(leader.split("RESULT ", 1)[1].splitlines()[0])
    assert res["hung"] == [False, False]
    for tag in TAGS:
        err = res["errors"][tag]
        assert err.startswith("ERROR") and "plane stopped" in err, res
        assert res["ready"][tag] is False
        assert res["later"][tag] == "scheduler is stopped"
    assert res["multi_ready"] is False


# -- the env path -------------------------------------------------------------

def _http(method: str, url: str, body=None, timeout: float = 5.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _children(pid: int) -> list:
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(p))
    return out


def test_env_path_serves_every_tag_and_sigterm_ends_both_ranks():
    port, pport = _free_port(), _free_port()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=REPO, SERVE_BACKEND="torch",
               SERVE_DEVICE="cpu", SERVE_TP="2",
               SERVE_MODELS="a=tiny-tp,b=tiny-moe", SERVE_KV="paged",
               SERVE_QUANT="int8", SERVE_KV_QUANT="int8",
               SERVE_MAX_SEQ="256", SERVE_WARMUP="16",
               SERVE_ADDR=f"127.0.0.1:{port}",
               SERVE_PROFILE_PORT=str(pport), **CAP)
    for k in ("SERVE_COORDINATOR", "JAX_COORDINATOR", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "CKPT_DIR", "MODEL_CONFIG", "LLM_MODEL"):
        env.pop(k, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    deadline = time.monotonic() + LIMIT_S

    def left() -> float:
        return max(1.0, deadline - time.monotonic())
    followers: list = []
    statuses = []
    try:
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read()[-4000:]
            try:
                st, _ = _http("GET", url + "/readyz")
            except OSError:
                time.sleep(0.2)
                continue
            statuses.append(st)
            if st == 200:
                break
            time.sleep(0.2)
        assert statuses and statuses[-1] == 200, statuses
        # Ready means both engines warmed: each one's warmup probe ran.
        metrics = _http("GET", url + "/metrics")[1].decode()
        for tag in TAGS:
            line = next(x for x in metrics.splitlines()
                        if x.startswith(f'decode_device_ms{{model="{tag}"}}'))
            assert float(line.split()[-1]) > 0, line
        assert 503 in statuses, statuses
        followers = _children(proc.pid)
        assert len(followers) == 1
        for route in ("/api/tags", "/api/ps"):
            names = [m["name"] for m in json.loads(
                _http("GET", url + route)[1])["models"]]
            assert names == list(TAGS), (route, names)
        answers = {}
        for tag in (*TAGS, "no-such-tag"):
            st, body = _http("POST", url + "/api/generate", {
                "model": tag, "prompt": "hello there", "stream": False,
                "options": {"num_predict": 6}}, timeout=left())
            assert st == 200, body
            r = json.loads(body)
            assert r["done"] is True and r["eval_count"] >= 1
            answers[tag] = r["context"]
        assert answers["no-such-tag"] == answers["a"]
        st, body = _http("POST", f"http://127.0.0.1:{pport}/profile",
                         {"model": "b", "duration_ms": 100}, timeout=left())
        assert st == 200 and json.loads(gzip.decompress(body))
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=left())[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
    assert proc.returncode == 0, out[-4000:]
    time.sleep(0.5)
    for pid in followers:
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] == "Z"
    for rank in range(2):
        for tag in TAGS:
            line = out.split(f"tp rank {rank} model {tag} summary: ",
                             1)[1].splitlines()[0]
            assert json.loads(line)["digests_equal"] is True, line
    assert out.count("summary: ") == 2 * len(TAGS)
    assert "tp followers exited: rc [0]" in out


# -- the op lock --------------------------------------------------------------

def test_the_op_lock_grants_in_the_order_asked():
    lock = tp_mod._FairLock()
    order, waiting = [], []
    with lock:
        ts = []
        for i in range(4):
            t = threading.Thread(target=lambda i=i: (
                waiting.append(i), lock.__enter__(), order.append(i),
                lock.__exit__()))
            t.start()
            # Each thread has taken its ticket before the next starts.
            while lock._next != i + 2:
                time.sleep(0.001)
            ts.append(t)
    for t in ts:
        t.join(5)
    assert order == [0, 1, 2, 3] and lock.owner is None


def test_a_wait_on_a_loop_inside_an_op_is_refused():
    ch = tp_mod.TPChannel(mesh=None)
    ch.check_not_holding("run_on_loop")          # outside: fine
    with ch.lock:
        assert ch.lock.owner == threading.get_ident()
        with pytest.raises(RuntimeError, match="inside a tensor-parallel"):
            ch.check_not_holding("park_all")
    with pytest.raises(ValueError):
        ch.attach(0, object())
        ch.attach(0, object())


def test_multi_backend_lockstep_surface():
    class Eng:
        def __init__(self, follower):
            self.lockstep, self.is_follower = True, follower

    assert MultiBackend({"a": Eng(False), "b": Eng(False)}).lockstep
    multi = MultiBackend({"a": Eng(True), "b": Eng(True)})
    assert multi.is_follower and multi.followers == []
    multi.warmup((16,))                          # a follower: nothing
    lead = MultiBackend({"a": Eng(False)})
    with pytest.raises(RuntimeError, match="does not follow"):
        lead.follower_loop()
