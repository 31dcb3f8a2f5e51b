"""The KV tier, the session and prefix wire and the prefill replica class
under ``SERVE_TP = 2`` (serve/scheduler.py over serve/tp.py), on two gloo
ranks on the CPU, against the JAX ``TPUEngine`` on a ``tp = 2`` mesh of
the conftest's fake CPU devices and against the port at tp = 1, on the
reference's f32 quote weights (models/synth.quote_params) carried
across. Two layouts: the paged int8 pool (int8 weights, page size 16)
and the dense cache (f32 weights).

One world of two spawned ranks runs both layouts in turn (a fresh engine
on both ranks for each, its shutdown op ending the follower's loop),
under one 120 s limit. Before it starts, this process runs each layout
at tp = 1 and writes what the ranks import: a parked session and a
prefix entry of a second template. The ranks then:

- run a conversation's first turn, park it (at finish on the dense
  cache, ``park_all`` on the pool) and export it, then run the second
  turn, which wakes;
- import the tp = 1 session and wake it, export their co-pilot prefix,
  import the tp = 1 prefix and serve a prompt over it;
- serve ``/admin/disagg/prefill``'s handoff (``prefill_park``) and export
  the session it parks.

The tests hold:

- the woken second turn's greedy text against the JAX tp = 2 engine's
  and the port's tp = 1 text;
- the tp = 2 parked payload against the tp = 1 payload: every key and
  shape, layer 0 bitwise and later layers within one int8 step (the
  all-reduce adds the ranks' partial sums in another order, as in
  ``tests/test_torch_tp_engine.py``'s ``placement`` case; the dense
  cache's f32 within 1e-4 of its scale);
- sessions moving tp = 2 -> tp = 1 and tp = 1 -> tp = 2, each waking to
  the reply it gives where it was made; the one imported at tp = 2,
  parked and exported again, holds the imported bytes in its first
  turn's slots (each rank scattered its own heads);
- a tp = 2 prefix export importing into a tp = 1 engine (its k/v against
  the tp = 1 engine's own entry), and a tp = 1 one serving at tp = 2 and
  exported again byte for byte;
- a tp = 2 prefill-class handoff decoding on a tp = 1 replica to the
  cold reply.

Every spawned process has a time limit and is killed on the way out.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from p2p_llm_chat_tpu.parallel.mesh import make_mesh as ref_make_mesh
from p2p_llm_chat_tpu.parallel.sharding import shard_params as ref_shard
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.quant import quantize_params
from p2p_llm_chat_tpu_torch.serve import kv_tier
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX, TorchEngine
from p2p_llm_chat_tpu_torch.serve.prefix import token_hash
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120.0   # the spawned world, start to exit

CFG = get_config("tiny-tp")
BASE = dict(num_slots=2, max_seq=256, prefix_cache=True, prefill_chunk=0,
            kv_host_gb=1.0, kv_idle_s=1e9)
CASES = {
    "paged": dict(quant="int8", engine=dict(kv_mode="paged", page_size=16,
                                            kv_quant=True)),
    "dense": dict(quant="", engine=dict(kv_mode="dense")),
}
WARM = (64,)
MAX_NEW = 10
TURNS = ("abcabc hello hello, how are you", " and once more, my friend")
MIGRATE = "the quick brown fox jumps over"
PFX2 = "Summarise the following chat thread in one line:\n\n"
PFX_TAIL = "lunch moved to one"
HANDOFF = "0123456789 and a request handed from prefill to decode"

_RANK = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.quant import quantize_params
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh, sharding
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

d = os.environ["DIR"]
assert distributed.init_distributed(join_timeout_s=30)
m = distributed.multihost_mesh(mesh.MeshConfig(tp=2), "cpu")
spec = json.load(open(os.path.join(d, "spec.json")))
cfg = get_config("tiny-tp")


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


def opts():
    return GenerateOptions(max_tokens=spec["max_new"], temperature=0.0,
                           seed=1)


def run(eng, prompt, session="", ctx=()):
    stats = RequestStats()
    text = "".join(eng.generate_stream(GenerateRequest(
        prompt=prompt, session=session, context=tuple(ctx),
        options=opts()), stats))
    return [text, list(stats.context)]


def put(name, data):
    assert data is not None, name
    with open(os.path.join(d, name), "wb") as f:
        f.write(data)


def get(name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


def settle(sched, n):
    deadline = time.monotonic() + 15
    while sum(sched._tier.counts()) != n:
        assert time.monotonic() < deadline, sched._tier.counts()
        time.sleep(0.02)


out = {}
for mode, case in spec["cases"].items():
    tree = tree_of(os.path.join(d, "tiny-tp.npz"))
    if case["quant"]:
        tree = quantize_params(tree, mode=case["quant"])
    params = sharding.shard_model(tree, cfg, m, "cpu")
    eng = TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), mesh=m,
                      device="cpu", **dict(spec["base"], **case["engine"]))
    res = {}
    if eng.is_follower:
        eng.follower_loop()
    else:
        sched = eng.scheduler
        eng.warmup(tuple(spec["warm"]), background=False)
        turns = spec["turns"]
        res["turn1"] = run(eng, turns[0], "c1")
        settle(sched, 1)
        eng.session_park_all()
        res["counts"] = list(sched._tier.counts())
        put(f"{mode}.tp2.c1", eng.session_export("sid:c1"))
        res["turn2"] = run(eng, turns[1], "c1", res["turn1"][1])
        settle(sched, 1)
        res["imported"] = eng.session_import(get(f"{mode}.tp1.m")) is not None
        res["migrated"] = run(eng, turns[1], "m", spec["ctx_m"][mode])
        settle(sched, 2)
        eng.session_park_all()
        put(f"{mode}.tp2.m", eng.session_export("sid:m"))
        res["prefix_hashes"] = list(eng.prefix_hashes())
        for h in res["prefix_hashes"]:
            put(f"{mode}.tp2.pfx.{h}", eng.prefix_export(h))
        entry = eng.prefix_import(get(f"{mode}.tp1.pfx"))
        res["prefix_imported"] = entry is not None
        put(f"{mode}.tp2.pfx2", eng.prefix_export(entry.token_hash))
        res["prefixed"] = run(eng, spec["pfx2"] + spec["pfx_tail"])
        res["handoff"] = eng.prefill_park(GenerateRequest(
            prompt=spec["handoff"], session="h", options=opts()))
        put(f"{mode}.tp2.h", eng.session_export(res["handoff"]["key"]))
        res["metrics"] = eng.metrics_snapshot()
        eng.stop()
    res["digests"] = eng.scheduler.digests
    out[mode] = res
distributed.leave_world()
json.dump(out, open(os.path.join(d, f"rank{m.rank}.json"), "w"))
print("RANK DONE", m.rank, flush=True)
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


def _run(eng, prompt, session="", ctx=()):
    """One greedy turn: (text, context ids)."""
    stats = RequestStats()
    text = "".join(eng.generate_stream(GenerateRequest(
        prompt=prompt, session=session, context=tuple(ctx),
        options=GenerateOptions(max_tokens=MAX_NEW, temperature=0.0,
                                seed=1)), stats))
    return text, list(stats.context)


def _settle(sched, n: int) -> None:
    """Wait for the tier to hold ``n`` sessions (retention runs on the
    loop after a stream closes)."""
    deadline = time.monotonic() + 15
    while sum(sched._tier.counts()) != n:
        assert time.monotonic() < deadline, sched._tier.counts()
        time.sleep(0.02)


def _tp1(trees, mode: str, **kw) -> TorchEngine:
    """The port at tp = 1 on the quote weights (quantized whole)."""
    case = CASES[mode]
    tree = params_from_numpy(jax.tree.map(np.asarray, trees), device="cpu")
    if case["quant"]:
        tree = quantize_params(tree, mode=case["quant"])
    return TorchEngine(tree, CFG, ByteTokenizer(CFG.vocab_size), device="cpu",
                       **dict(BASE, **case["engine"], **kw))


@pytest.fixture(scope="module")
def quote(tmp_path_factory):
    """The reference's f32 quote tree of tiny-tp (unfused) and the
    directory its npz is written to."""
    d = tmp_path_factory.mktemp("tp_tier")
    tree = quote_params(ref_config("tiny-tp"), jax.random.PRNGKey(3),
                        dtype=jnp.float32)
    np.savez(d / "tiny-tp.npz", **_flat(tree))
    return d, tree


@pytest.fixture(scope="module")
def one(quote):
    """Each layout at tp = 1, run before the world starts: {mode: what the
    tests compare with}, and the files the ranks import."""
    d, tree = quote
    out = {}
    for mode in CASES:
        eng = _tp1(tree, mode)
        sched = eng.scheduler
        try:
            eng.warmup(WARM, background=False)
            res = {"turn1": _run(eng, TURNS[0], "c1")}
            _settle(sched, 1)
            eng.session_park_all()
            res["c1"] = eng.session_export("sid:c1")
            res["turn2"] = _run(eng, TURNS[1], "c1", res["turn1"][1])
            res["m1"] = _run(eng, MIGRATE, "m")
            _settle(sched, 2)
            eng.session_park_all()
            (d / f"{mode}.tp1.m").write_bytes(eng.session_export("sid:m"))
            res["m2"] = _run(eng, TURNS[1], "m", res["m1"][1])
            res["pfx"] = {e.token_hash: (e.k.clone(), e.v.clone())
                          for e in sched._prefix.snapshot()}
            sched.run_on_loop(lambda: sched.register_prefix(PFX2))
            h = token_hash(sched.tokenizer.encode(PFX2, add_bos=True)[:-1])
            (d / f"{mode}.tp1.pfx").write_bytes(eng.prefix_export(h))
            res["prefixed"] = _run(eng, PFX2 + PFX_TAIL)
            res["handoff"] = _run(eng, HANDOFF)
        finally:
            eng.stop()
        out[mode] = res
    return out


@pytest.fixture(scope="module")
def world(quote, one):
    """Both layouts run by two spawned ranks (started here, awaited by the
    first test that reads them): rank 0's results, rank 1's."""
    d, _ = quote
    (d / "spec.json").write_text(json.dumps({
        "cases": CASES, "base": BASE, "warm": WARM, "max_new": MAX_NEW,
        "turns": TURNS, "pfx2": PFX2, "pfx_tail": PFX_TAIL,
        "handoff": HANDOFF,
        "ctx_m": {mode: one[mode]["m1"][1] for mode in CASES}}))
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


def _jax_turn2(tree, mode: str) -> str:
    """The JAX engine on a tp = 2 mesh with the tier on: the first turn,
    then the second, which wakes; the second's text."""
    case = CASES[mode]
    rcfg = ref_config("tiny-tp")
    mesh = ref_make_mesh(RefMeshConfig(tp=2), devices=jax.devices()[:2])
    params = ref_shard(tree, ref_llama.param_axes(rcfg), mesh)
    if case["quant"]:
        params = ref_quant.quantize_params(params, mesh=mesh,
                                           mode=case["quant"])
    eng = TPUEngine(params, rcfg, RefByteTokenizer(rcfg.vocab_size),
                    mesh=mesh, **dict(BASE, **case["engine"]))
    try:
        ctx = ()
        for turn in TURNS:
            stats = RefStats()
            text = "".join(eng.generate_stream(RefRequest(
                prompt=turn, session="c1", context=tuple(ctx),
                options=RefOptions(max_tokens=MAX_NEW, temperature=0.0,
                                   seed=1)), stats))
            ctx = stats.context
            deadline = time.monotonic() + 15
            while sum(eng.scheduler._tier.counts()) != 1:
                assert time.monotonic() < deadline
                time.sleep(0.02)
        assert eng.scheduler.metrics_snapshot()["kv_waked_total"] == 1
        return text
    finally:
        eng.stop()
        ref_quant.set_mm_impl("auto")


def _close_layers(got: np.ndarray, want: np.ndarray, label: str) -> None:
    """Layer 0 bitwise, later layers within one int8 step (int8) or 1e-4
    of the scale (floats): the all-reduce adds the ranks' partial sums in
    another order."""
    assert got.shape == want.shape and got.dtype == want.dtype, label
    assert np.array_equal(got[0], want[0]), label
    if got.dtype == np.int8:
        assert np.abs(got.astype(np.int32)
                      - want.astype(np.int32)).max() <= 1, label
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=label)


@pytest.mark.parametrize("mode", list(CASES))
def test_woken_turn_answers_the_jax_tp2_engine_and_tp1(quote, one, world,
                                                       mode):
    r0, r1 = (ranks[mode] for ranks in world())
    got = r0["turn2"][0]
    assert r0["turn1"] == list(one[mode]["turn1"])
    assert got and got == one[mode]["turn2"][0]
    assert got == _jax_turn2(quote[1], mode)
    m = r0["metrics"]
    assert m["kv_waked_total"] >= 2 and m["kv_parked_total"] >= 1, m
    assert r0["digests"] == r1["digests"] and len(set(r0["digests"])) == 1


@pytest.mark.parametrize("mode", list(CASES))
def test_parked_payload_equals_the_tp1_payload(quote, one, world, mode):
    world()
    got = kv_tier.deserialize_session((quote[0] / f"{mode}.tp2.c1")
                                      .read_bytes())
    want = kv_tier.deserialize_session(one[mode]["c1"])
    assert (got.key, got.tokens, got.length, got.host[1]) == (
        want.key, want.tokens, want.length, want.host[1])
    assert len(got.host[0]) == len(want.host[0]) == (
        4 if mode == "paged" else 2)
    assert world()[0][mode]["counts"] == [0, 1]
    for i, (g, w) in enumerate(zip(got.host[0], want.host[0])):
        assert g.shape == w.shape and g.dtype == w.dtype, (mode, i)
        _close_layers(_slots(g, got.length), _slots(w, got.length),
                      f"{mode} array {i}")
    heads = CFG.num_kv_heads
    assert got.host[0][0].shape[-2 if mode == "paged" else 2] == heads


def _slots(a: torch.Tensor, n: int) -> np.ndarray:
    """A payload array by token slot, its first ``n`` (the session's; the
    rest of the last page and the padding pages hold what nobody
    trusts): pages [L, P, ps, H, D] and head-major scales [L, P, H,
    ps_pad] of page size 16 as [L, n, H(, D)], a dense row [L, W, H, D]
    as [L, n, H, D]."""
    a = a.numpy()
    if a.ndim == 4 and a.shape[-1] == 128:          # scales
        L, P, H, _ = a.shape
        a = a[..., :16].transpose(0, 1, 3, 2).reshape(L, P * 16, H)
    elif a.ndim == 5:                                # pages
        L, P, ps, H, D = a.shape
        a = a.reshape(L, P * ps, H, D)
    return a[:, :n]


@pytest.mark.parametrize("mode", list(CASES))
def test_sessions_move_between_tp2_and_tp1(quote, one, world, mode):
    r0 = world()[0][mode]
    # tp = 1 -> tp = 2: the imported session wakes to tp = 1's own reply,
    # and each rank holds its own heads of it: parked and exported again,
    # its first turn's slots are the imported bytes.
    assert r0["imported"] is True
    assert r0["migrated"][0] == one[mode]["m2"][0]
    assert r0["migrated"][1] == one[mode]["m2"][1]
    sent = kv_tier.deserialize_session((quote[0] / f"{mode}.tp1.m")
                                       .read_bytes())
    back = kv_tier.deserialize_session((quote[0] / f"{mode}.tp2.m")
                                       .read_bytes())
    assert back.tokens[:sent.length] == sent.tokens
    assert back.length > sent.length
    for i, (b, a) in enumerate(zip(back.host[0], sent.host[0])):
        assert np.array_equal(_slots(b, sent.length),
                              _slots(a, sent.length)), (mode, i)
    # tp = 2 -> tp = 1.
    eng = _tp1(quote[1], mode)
    try:
        data = (quote[0] / f"{mode}.tp2.c1").read_bytes()
        assert eng.session_import(data) is not None
        text, ctx = _run(eng, TURNS[1], "c1", r0["turn1"][1])
        assert eng.scheduler.metrics_snapshot()["kv_waked_total"] == 1
    finally:
        eng.stop()
    assert (text, ctx) == (r0["turn2"][0], r0["turn2"][1])


@pytest.mark.parametrize("mode", list(CASES))
def test_prefix_wire_between_tp2_and_tp1(quote, one, world, mode):
    r0 = world()[0][mode]
    # The tp = 2 co-pilot prefix imports into a tp = 1 engine.
    h = token_hash(ByteTokenizer(CFG.vocab_size).encode(
        SUGGEST_PREFIX, add_bos=True)[:-1])
    assert h in r0["prefix_hashes"] and h in one[mode]["pfx"]
    eng = _tp1(quote[1], mode, prefix_texts=())
    try:
        entry = eng.prefix_import(
            (quote[0] / f"{mode}.tp2.pfx.{h}").read_bytes())
        assert entry is not None and entry.token_hash == h
        assert entry.ids == tuple(eng.scheduler.tokenizer.encode(
            SUGGEST_PREFIX, add_bos=True)[:-1])
        for got, want in zip((entry.k, entry.v), one[mode]["pfx"][h]):
            _close_layers(got.numpy(), want.numpy(), f"{mode} prefix")
    finally:
        eng.stop()
    # A tp = 1 prefix imports at tp = 2 (each rank its heads: exported
    # again, it is the same payload) and serves as it does at tp = 1.
    assert r0["prefix_imported"] is True
    assert ((quote[0] / f"{mode}.tp2.pfx2").read_bytes()
            == (quote[0] / f"{mode}.tp1.pfx").read_bytes())
    assert r0["prefixed"] == list(one[mode]["prefixed"])
    assert r0["metrics"]["serve_prefix_admits_total"] >= 1


@pytest.mark.parametrize("mode", list(CASES))
def test_prefill_handoff_from_tp2_decodes_on_tp1(quote, one, world, mode):
    r0 = world()[0][mode]
    info = r0["handoff"]
    assert info["key"] == "sid:h" and info["len"] > 16
    eng = _tp1(quote[1], mode)
    try:
        data = (quote[0] / f"{mode}.tp2.h").read_bytes()
        assert eng.session_import(data) is not None
        text, ctx = _run(eng, HANDOFF, "h")
        assert eng.scheduler.metrics_snapshot()["kv_waked_total"] == 1
    finally:
        eng.stop()
    assert (text, ctx) == tuple(one[mode]["handoff"])
