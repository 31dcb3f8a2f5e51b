"""``SERVE_TP`` inside the port's continuous-batching engine (serve/tp.py:
the leader's device ops streamed to a follower rank) on two gloo ranks on
the CPU, against the JAX ``TPUEngine`` on a ``tp = 2`` mesh of the
conftest's fake CPU devices, on the reference's f32 quote weights
(models/synth.quote_params) carried across: every rank loads the numpy
tree and takes its shard (quantized whole first where the case is int8).

One world of two spawned ranks runs every engine case in turn (each a
fresh engine on both ranks, its shutdown op ending the follower's loop),
under one 60 s limit:

- ``dense`` and ``paged`` (the counterparts of ``test_serve_tp.py::
  test_tp_engine_matches_unsharded_oracle``), ``paged-int8`` (int8
  weights and pool, the prefix cache on, a 16-token chunk, so the long
  prompts take four chunks, one of them over the co-pilot prefix), the
  same chunks and prefix over the dense cache (``dense-chunked``),
  ``prefix-spec`` (``spec_k = 3`` over the prefix cache, ``::
  test_tp_engine_with_prefix_and_spec``: equal ``serve_prefix_admits_
  total``), ``spec-tree`` (tree verify over the pool), ``paged-int4``
  (``wo``'s single int4 group spans both ranks' rows) and ``moe``
  (``tiny-moe``, paged int8): three concurrent greedy requests answer the
  JAX engine's texts, and both ranks' token digests are equal;
- ``placement`` (``::test_tp_pool_and_fused_weights_are_sharded``): each
  rank's pool holds Hkv/2 heads and its ``wqkv`` / ``wgu`` their column
  shard, and after the same admissions rank r's pool is heads
  [r·Hkv/2, (r+1)·Hkv/2) of a one-card engine's pool: layer 0's int8
  bytes and scales bitwise (its input is the exact embedding), every
  later layer's within one int8 step (their inputs come through an
  all-reduce, which adds the rank's partial sums in another order);
- ``lockstep``: an ``/api/embed`` sent while two streams decode answers,
  the streams finish, and both ranks' digests are equal.

A fault planted in the follower's tick op alone ends the plane instead of
hanging it: the follower exits non-zero, and the leader fails its
requests, turns not ready and refuses new ones.

The env path: ``SERVE_DEVICE=cpu SERVE_TP=2 ... python -m
p2p_llm_chat_tpu_torch.serve`` starts its follower, answers over HTTP,
and SIGTERM ends both with rc 0 and no process left (``SERVE_MODELS``
under ``SERVE_TP``: tests/test_torch_tp_multi.py). Every spawned process
has a time limit and a thread cap, and is killed on the way out.
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
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.quant import quantize_params
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest)
from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX, TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60.0   # each spawned world, start to exit

PROMPTS = ["tensor parallel", "serving check", "third request"]
LONG = [SUGGEST_PREFIX + "are we still on for lunch tomorrow at noon, "
        "or later?", "0123456789:;<=>?0123456789 and then some more text, "
        "on and on"]
PAGED = dict(kv_mode="paged", page_size=16)
CASES = {
    "dense": dict(cfg="tiny-tp", quant="", engine=dict(kv_mode="dense")),
    "paged": dict(cfg="tiny-tp", quant="", engine=PAGED),
    "paged-int8": dict(cfg="tiny-tp", quant="int8", warm=[64],
                       prompts=PROMPTS[:1] + LONG,
                       engine=dict(PAGED, kv_quant=True, max_seq=256,
                                   prefix_cache=True, prefill_chunk=16)),
    "dense-chunked": dict(cfg="tiny-tp", quant="", warm=[64],
                          prompts=PROMPTS[:1] + LONG,
                          engine=dict(kv_mode="dense", max_seq=256,
                                      prefix_cache=True, prefill_chunk=16)),
    "prefix-spec": dict(cfg="tiny-tp", quant="", warm=[64, 128],
                        prompts=[SUGGEST_PREFIX + "see you at ten?"]
                        + PROMPTS[:2], max_new=40,
                        engine=dict(max_seq=256, spec_k=3,
                                    prefix_cache=True)),
    "spec-tree": dict(cfg="tiny-tp", quant="", max_new=40,
                      engine=dict(PAGED, spec_k=3, spec_tree_nodes=8)),
    "paged-int4": dict(cfg="tiny-tp", quant="int4", engine=PAGED),
    "moe": dict(cfg="tiny-moe", quant="int8",
                engine=dict(PAGED, kv_quant=True)),
    "placement": dict(cfg="tiny-tp", quant="int8", sequential=True,
                      pool=True, engine=dict(PAGED, kv_quant=True)),
    "lockstep": dict(cfg="tiny-tp", quant="", embed_in_flight=True,
                     engine=PAGED),
}
BASE = dict(num_slots=2, max_seq=128, prefix_cache=False, prefill_chunk=0)
MAX_NEW = 8

_RANK = r"""
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
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

d = os.environ["DIR"]
assert distributed.init_distributed(join_timeout_s=30)
m = distributed.multihost_mesh(mesh.MeshConfig(tp=2), "cpu")
rank = m.rank
spec = json.load(open(os.path.join(d, "cases.json")))


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


def gen(eng, prompt, n, out, i, started=None):
    req = GenerateRequest(prompt=prompt, options=GenerateOptions(
        max_tokens=n))
    parts = []
    for delta in eng.generate_stream(req):
        parts.append(delta)
        if started is not None:
            started.set()
    out[i] = "".join(parts)


def drive(eng, case):
    prompts = case["prompts"]
    texts = [None] * len(prompts)
    if case.get("sequential"):
        for i, p in enumerate(prompts):
            gen(eng, p, case["max_new"], texts, i)
        return {"texts": texts}
    ts = [threading.Thread(target=gen, args=(eng, p, case["max_new"],
                                             texts, i))
          for i, p in enumerate(prompts)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    res = {"texts": texts}
    if case.get("embed_in_flight"):
        live, began = [None, None], [threading.Event(), threading.Event()]
        ts = [threading.Thread(target=gen, args=(eng, p, 40, live, i,
                                                 began[i]))
              for i, p in enumerate(prompts[:2])]
        for t in ts:
            t.start()
        for e in began:
            e.wait(30)
        vecs, n = eng.embed(["see you at noon", "hi"])
        busy = sum(s is not None for s in eng.scheduler._slots)
        for t in ts:
            t.join()
        res.update(embed=vecs, embed_tokens=n, live=live, busy=busy)
    return res


out = {}
for name, case in spec["cases"].items():
    cfg = get_config(case["cfg"])
    tree = tree_of(os.path.join(d, case["cfg"] + ".npz"))
    if case["quant"]:
        tree = quantize_params(tree, mode=case["quant"])
    params = sharding.shard_model(tree, cfg, m, "cpu")
    eng = TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), mesh=m,
                      device="cpu", **dict(spec["base"], **case["engine"]))
    res = {}
    if eng.is_follower:
        eng.follower_loop()
    else:
        if case.get("warm"):
            eng.warmup(tuple(case["warm"]), background=False)
        res = drive(eng, case)
        res["metrics"] = eng.metrics_snapshot()
        eng.stop()
    sched = eng.scheduler
    res["digests"] = sched.digests
    if case.get("pool"):
        lay = sched._params["layers"]
        res["shapes"] = {k: list(lay[k].q.shape) for k in ("wqkv", "wgu")}
        res["pool_k"] = list(sched._cache.k.shape)
        c = sched._cache
        np.savez(os.path.join(d, f"pool{rank}.npz"), k=c.k.numpy(),
                 v=c.v.numpy(), ks=c.k_scale.numpy(), vs=c.v_scale.numpy())
    out[name] = res
distributed.leave_world()
json.dump(out, open(os.path.join(d, f"rank{rank}.json"), "w"))
print("RANK DONE", rank, flush=True)
"""


_FAULT = r"""
import json, os, sys, threading
sys.path.insert(0, os.environ["REPO"])
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.llama import init_params
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

assert distributed.init_distributed(join_timeout_s=30)
m = distributed.multihost_mesh(mesh.MeshConfig(tp=2), "cpu")
cfg = get_config("tiny-tp")
params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu", mesh=m)
eng = TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), mesh=m,
                  device="cpu", num_slots=2, max_seq=128, prefix_cache=False,
                  prefill_chunk=0, kv_mode="paged", page_size=16)
if eng.is_follower:
    def planted(*args):
        raise RuntimeError("planted fault")
    eng.scheduler._dev_tick = planted
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
           ready=eng.scheduler.ready)
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


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def _prompts(case) -> list:
    return case.get("prompts", PROMPTS)


@pytest.fixture(scope="module")
def quote(tmp_path_factory):
    """The reference's f32 quote trees (unfused) of tiny-tp and tiny-moe,
    and the directory their npz files are written to."""
    d = tmp_path_factory.mktemp("tp_engine")
    trees = {}
    for name in ("tiny-tp", "tiny-moe"):
        rcfg = ref_config(name)
        trees[name] = quote_params(rcfg, jax.random.PRNGKey(3),
                                   dtype=jnp.float32)
        np.savez(d / f"{name}.npz", **_flat(trees[name]))
    return d, trees


@pytest.fixture(scope="module")
def world(quote):
    """Every case run by two spawned ranks (started here, awaited by the
    first test that reads them); {case: rank 0's results}, rank 1's."""
    d, _ = quote
    cases = {k: dict(v, prompts=_prompts(v), max_new=v.get("max_new",
                                                            MAX_NEW))
             for k, v in CASES.items()}
    (d / "cases.json").write_text(json.dumps({"cases": cases,
                                              "base": BASE}))
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, REPO=REPO, PYTHONPATH=REPO, DIR=str(d),
                   SERVE_COORDINATOR=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   SERVE_DEVICE="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + LIMIT_S
    done: dict = {}

    def results():
        if not done:
            try:
                outs = [p.communicate(timeout=max(
                    0.5, deadline - time.monotonic()))[0] for p in procs]
            finally:
                _kill(procs)
            for p, out in zip(procs, outs):
                assert p.returncode == 0, out[-4000:]
            done["ranks"] = [json.load(open(d / f"rank{r}.json"))
                             for r in range(2)]
        return done["ranks"]
    try:
        yield results
    finally:
        _kill(procs)


def _ref_texts(trees, case) -> list:
    """The JAX engine on a tp = 2 mesh: the case's prompts at once."""
    rcfg = ref_config(case["cfg"])
    fam = ref_mixtral if rcfg.is_moe else ref_llama
    mesh = ref_make_mesh(RefMeshConfig(tp=2), devices=jax.devices()[:2])
    params = ref_shard(trees[case["cfg"]], fam.param_axes(rcfg), mesh)
    if case["quant"]:
        params = ref_quant.quantize_params(params, mesh=mesh,
                                           mode=case["quant"])
    eng = TPUEngine(params, rcfg, RefByteTokenizer(rcfg.vocab_size),
                    mesh=mesh, **dict(BASE, **case["engine"]))
    try:
        if case.get("warm"):
            eng.warmup(buckets=tuple(case["warm"]))
        prompts = _prompts(case)
        out = [None] * len(prompts)

        def go(i):
            out[i] = "".join(eng.generate_stream(RefRequest(
                prompt=prompts[i], options=RefOptions(
                    max_tokens=case.get("max_new", MAX_NEW)))))
        ts = [threading.Thread(target=go, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        return out, eng.scheduler.metrics_snapshot()
    finally:
        eng.stop()
        ref_quant.set_mm_impl("auto")


@pytest.mark.parametrize("name", ["dense", "paged", "paged-int8",
                                  "dense-chunked", "prefix-spec",
                                  "spec-tree", "paged-int4", "moe"])
def test_tp2_engine_answers_the_jax_tp2_engines_texts(quote, world, name):
    case = CASES[name]
    want, ref_metrics = _ref_texts(quote[1], case)
    assert all(want) and len(set(want)) == len(want), want
    r0, r1 = (ranks[name] for ranks in [world()[0], world()[1]])
    assert r0["texts"] == want
    assert r0["digests"] == r1["digests"] and len(set(r0["digests"])) == 1
    m = r0["metrics"]
    if case["engine"].get("prefill_chunk"):
        assert m["prefill_chunks_total"] >= 3 * 2, m
    if case["engine"].get("prefix_cache"):
        assert m["serve_prefix_admits_total"] >= 1
        assert (m["serve_prefix_admits_total"]
                == ref_metrics["serve_prefix_admits_total"])
    if case["engine"].get("spec_k"):
        assert m["serve_spec_accepted_total"] > 0, m


def test_pool_and_fused_weights_are_cut_over_the_ranks(quote, world):
    d, trees = quote
    case = CASES["placement"]
    cfg = get_config("tiny-tp")
    ranks = world()
    kv = cfg.num_kv_heads // 2
    for r in range(2):
        res = ranks[r]["placement"]
        assert res["pool_k"][3] == kv
        assert res["shapes"]["wqkv"][-1] == (cfg.q_dim + 2 * cfg.kv_dim) // 2
        assert res["shapes"]["wgu"][-1] == cfg.intermediate_size
    # The same weights and requests on one card.
    tree = quantize_params(params_from_numpy(
        jax.tree.map(np.asarray, trees["tiny-tp"]), device="cpu"),
        mode="int8")
    one = TorchEngine(tree, cfg, ByteTokenizer(cfg.vocab_size),
                      device="cpu", **dict(BASE, **case["engine"]))
    try:
        texts = ["".join(one.generate_stream(GenerateRequest(
            prompt=p, options=GenerateOptions(max_tokens=MAX_NEW))))
            for p in PROMPTS]
        c = one.scheduler._cache
        want = {"k": c.k.numpy(), "v": c.v.numpy(), "ks": c.k_scale.numpy(),
                "vs": c.v_scale.numpy()}
    finally:
        one.stop()
    assert ranks[0]["placement"]["texts"] == texts
    for r in range(2):
        got = np.load(d / f"pool{r}.npz")
        for key in ("k", "v"):
            w = want[key][:, :, :, r * kv:(r + 1) * kv]
            assert got[key].shape == w.shape
            assert np.array_equal(got[key][0], w[0]), (key, r)
            assert np.abs(got[key].astype(np.int32)
                          - w.astype(np.int32)).max() <= 1, (key, r)
        for key in ("ks", "vs"):
            w = want[key][:, :, r * kv:(r + 1) * kv]
            assert np.array_equal(got[key][0], w[0]), (key, r)
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=0)
        assert np.abs(got["k"]).max() > 0


def test_embed_in_flight_keeps_the_ranks_in_step(world):
    r0, r1 = world()[0]["lockstep"], world()[1]["lockstep"]
    assert r0["busy"] >= 1 and all(r0["live"])
    vecs = np.asarray(r0["embed"])
    assert vecs.shape == (2, get_config("tiny-tp").hidden_size)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, rtol=1e-5)
    assert r0["digests"] == r1["digests"] and len(set(r0["digests"])) == 1


def test_a_failed_op_on_the_follower_ends_the_plane():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FAULT], env=dict(
            os.environ, REPO=REPO, PYTHONPATH=REPO, SERVE_DEVICE="cpu",
            SERVE_COORDINATOR=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    deadline = time.monotonic() + LIMIT_S
    try:
        outs = [p.communicate(timeout=max(0.5, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        _kill(procs)
    leader, follower = outs
    assert procs[1].returncode != 0, follower[-4000:]
    assert "op tick failed; leaving the world" in follower
    assert "planted fault" in follower
    assert procs[0].returncode == 0, leader[-4000:]
    assert "the plane stops" in leader
    res = json.loads(leader.split("RESULT ", 1)[1].splitlines()[0])
    assert res["hung"] == [False, False]
    assert all(e and "plane stopped" in e for e in res["errors"]), res
    assert res["ready"] is False
    assert res["later"] == "scheduler is stopped"


def _get(url: str, timeout: float = 5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _post(url: str, body: dict, timeout: float):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _serve(env_extra: dict) -> subprocess.Popen:
    # One intra-op thread a rank, as the in-process rank scripts set: two
    # uncapped ranks take a thread per core each, and beside the other
    # test workers that starves them.
    env = dict(os.environ, PYTHONPATH=REPO, SERVE_BACKEND="torch",
               SERVE_DEVICE="cpu", SERVE_TP="2", MODEL_CONFIG="tiny-tp",
               SERVE_MAX_SEQ="256", SERVE_WARMUP="16", OMP_NUM_THREADS="1",
               **env_extra)
    for k in ("SERVE_COORDINATOR", "JAX_COORDINATOR", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "SERVE_MODELS", "CKPT_DIR"):
        if k not in env_extra:
            env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _followers_of(pid: int) -> list:
    """Live processes whose parent is ``pid``."""
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


def test_env_path_serves_and_sigterm_ends_both_ranks():
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    proc = _serve({"SERVE_ADDR": f"127.0.0.1:{port}", "SERVE_KV": "paged",
                   "SERVE_QUANT": "int8", "SERVE_KV_QUANT": "int8"})
    deadline = time.monotonic() + LIMIT_S
    followers: list = []
    try:
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read()[-4000:]
            try:
                _get(url + "/readyz")
                break
            except OSError:
                time.sleep(0.3)
        followers = _followers_of(proc.pid)
        assert len(followers) == 1
        r = _post(url + "/api/generate", {
            "model": "tiny-tp", "prompt": "hello there", "stream": False,
            "options": {"num_predict": 6}},
            timeout=max(1.0, deadline - time.monotonic()))
        assert r["done"] is True and r["eval_count"] >= 1
        e = _post(url + "/api/embed", {"model": "tiny-tp", "input": ["hi"]},
                  timeout=max(1.0, deadline - time.monotonic()))
        assert len(e["embeddings"][0]) == get_config("tiny-tp").hidden_size
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
    assert proc.returncode == 0, out[-4000:]
    time.sleep(0.5)
    for pid in followers:
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] == "Z"
    assert "tp follower 1 shutting down" in out
    assert out.count("summary: ") == 2 and '"digests_equal": true' in out
    assert "tp followers exited: rc [0]" in out
