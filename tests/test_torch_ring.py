"""The port's ring and sequence-parallel forms (p2p_llm_chat_tpu_torch/
parallel/ring.py: ``ring_prefill``, ``sp_decode_step``,
``moe_ring_mlp_fn``) on one world of four spawned ranks over gloo,
against the JAX forms (p2p_llm_chat_tpu/parallel/ring.py) on meshes of
the conftest's fake CPU devices, on the reference's weights carried
across (each rank's cut by ``shard_ring_params``):

- ring prefill at sp = 2 (ranks 0-1) and sp = 4 on ``tiny`` (f32): each
  rank's chunk of the logits and its sequence shard of the cache;
- ragged rows at sp = 4 (prompts of 20 and 32 in a bucket of 32): every
  real position's logits;
- sp decode at sp = 4 after prompts of 12 and 24 in a bucket of 32: rows
  whose length lies before a rank's shard attend 0 slots there; three
  steps, row 1 parked by ``active`` in the second; logits, lengths and
  caches;
- sp 2 x tp 2 on ``tiny-tp``: prefill and three decode steps, each rank's
  cache at its sequence shard and its half of the kv heads;
- sp 2 x ep 2 on ``tiny-moe`` (``moe_ring_mlp_fn``): prefill and two
  decode steps;
- the reference's ``quantize_params`` int8 weights at sp = 4: prefill
  and one decode step;
- decode logits bitwise equal on every rank (merged and projected alike),
  and the prefill chunk bitwise equal on the two tp ranks of a chunk;
- every cache compared at each row's committed slots (the reference
  also scatters a step into a shard that does not hold its slot, at a
  negative local index that JAX wraps, a slot no row trusts yet);
- the reference's asserts as ValueErrors (a mixed mesh, ``tp`` with an
  MoE, ``ep`` without one).

Tolerance: f32 within 1e-4 of max|value| (the hops and shards merge in
another order); int8 within 1e-3 of max|value|. The JAX forms run under
``jax.jit``. The world runs once for the whole file (a 110 s limit);
its ranks are killed on the way out.
"""

import functools
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.quant import quantize_params
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from p2p_llm_chat_tpu.parallel.mesh import make_mesh as ref_make_mesh
from p2p_llm_chat_tpu.parallel.ring import (moe_ring_mlp_fn, ring_prefill,
                                            sp_decode_step)

pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4       # of max|value|: f32, merged in another order
TOL_INT8 = 1e-3  # of max|value|: int8 weights, the scale applied elsewhere

# case -> (config, mesh axes, weights file, decode steps, moe)
CASES = {
    "sp2": ("tiny", dict(sp=2), "tiny.npz", 0, False),
    "sp4": ("tiny", dict(sp=4), "tiny.npz", 0, False),
    "ragged": ("tiny", dict(sp=4), "tiny.npz", 0, False),
    "decode": ("tiny", dict(sp=4), "tiny.npz", 3, False),
    "tp": ("tiny-tp", dict(sp=2, tp=2), "tiny_tp.npz", 3, False),
    "ep": ("tiny-moe", dict(ep=2, sp=2), "tiny_moe.npz", 2, True),
    "int8": ("tiny", dict(sp=4), "tiny_int8.npz", 1, False),
}

_RANK = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.quant import QTensor
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh
from p2p_llm_chat_tpu_torch.parallel.ring import (
    moe_ring_mlp_fn, ring_prefill, shard_ring_params, sp_decode_step)

d = os.environ["DIR"]
cases = json.loads(os.environ["CASES"])
assert distributed.init_distributed(join_timeout_s=60)
rank = torch.distributed.get_rank()


def tree(path):
    w = np.load(path)
    out = {}
    for k in w.files:
        node = out
        *p, leaf = k.split("/")
        for x in p:
            node = node.setdefault(x, {})
        node[leaf] = torch.from_numpy(w[k])

    def fix(n):
        if isinstance(n, dict):
            if set(n) == {"q", "s"}:
                return QTensor(q=n["q"], s=n["s"])
            return {k: fix(v) for k, v in n.items()}
        return n
    return fix(out)


# Every rank builds every mesh, in one order (new_group is collective).
meshes = {}
for name, (_, axes, _, _, _) in cases.items():
    cfg = mesh.MeshConfig(**axes)
    meshes[name] = mesh.make_mesh(cfg, list(range(cfg.size)),
                                  backend="gloo")
out = {}
with torch.no_grad():
    for name, (cname, axes, wfile, steps, moe) in cases.items():
        m = meshes[name]
        if not m.coords:
            continue
        cfg = get_config(cname)
        x = np.load(os.path.join(d, f"{name}_in.npz"))
        params = shard_ring_params(tree(os.path.join(d, wfile)), cfg, m,
                                   "cpu")
        fn = moe_ring_mlp_fn(cfg, "ep", m) if moe else None
        toks = torch.from_numpy(x["toks"]).long()
        lens = torch.from_numpy(x["lens"])
        lg, cache = ring_prefill(params, cfg, toks, lens, m, mlp_fn=fn)
        out[f"{name}/prefill"] = lg.numpy()
        for i in range(steps):
            lg, cache = sp_decode_step(
                params, cfg, torch.from_numpy(x["steps"][i]).long()[:, None],
                cache, m, active=torch.from_numpy(x["active"][i]),
                mlp_fn=fn)
            out[f"{name}/step{i}"] = lg.numpy()
        Sl = cache.max_seq
        out[f"{name}/k"] = cache.k[:, :, :Sl].numpy()
        out[f"{name}/v"] = cache.v[:, :, :Sl].numpy()
        out[f"{name}/lengths"] = cache.lengths.numpy()
        out[f"{name}/coords"] = np.array([m.coords["sp"], m.coords["tp"]])
distributed.leave_world()
np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
print("RANK DONE", rank, flush=True)
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
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return {f"{prefix}q": np.asarray(tree.q),
                f"{prefix}s": np.asarray(tree.s)}
    return {prefix[:-1]: np.asarray(tree)}


def _spawn_ranks(code: str, n: int, env_extra: dict, timeout: float):
    """Run ``code`` as ranks 0..n-1 of one gloo world; returns their
    outputs. Every rank is killed on the way out."""
    port = _free_port()
    procs = []
    try:
        for pid in range(n):
            env = dict(os.environ, REPO=REPO, PYTHONPATH=REPO,
                       SERVE_COORDINATOR=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(pid),
                       SERVE_DEVICE="cpu", **env_extra)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(0.5, deadline
                                          - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _inputs(name, cfg, rng):
    """(tokens [B, S], prompt lengths, decode tokens, active per step)."""
    steps = CASES[name][3]
    B = 2
    if name in ("sp2", "sp4"):
        S, lens = 32, [32, 32]
    elif name == "ragged":
        S, lens = 32, [20, 32]
    elif name == "decode":
        S, lens = 32, [12, 24]
    elif name == "int8":
        S, lens = 32, [30, 30]
    else:                            # the tp and ep compositions
        S = 16
        lens = [S - steps - 1] * B
    toks = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab_size, n)
    dec = rng.integers(3, cfg.vocab_size, (max(steps, 1), B)).astype(
        np.int32)
    active = np.ones((max(steps, 1), B), bool)
    if steps >= 2:
        active[1, 1] = False
    return toks, np.array(lens, np.int32), dec, active


def _jax_forms(cfg, axes: dict, moe: bool):
    """The JAX ring prefill and sp decode step of a case, each jitted
    once (the config, mesh and MLP are the case's)."""
    mesh = ref_make_mesh(RefMeshConfig(**axes))
    fn = moe_ring_mlp_fn(cfg, "ep") if moe else None
    return (jax.jit(functools.partial(ring_prefill, config=cfg, mesh=mesh,
                                      mlp_fn=fn)),
            jax.jit(functools.partial(sp_decode_step, config=cfg, mesh=mesh,
                                      mlp_fn=fn)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_world")
    trees = {}
    for fname, cname, quant in (("tiny.npz", "tiny", False),
                                ("tiny_int8.npz", "tiny", True),
                                ("tiny_tp.npz", "tiny-tp", False),
                                ("tiny_moe.npz", "tiny-moe", False)):
        cfg = ref_config(cname)
        fam = ref_mixtral if cfg.is_moe else ref_llama
        p = fam.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        p = quantize_params(p) if quant else p
        trees[fname] = p
        np.savez(d / fname, **_flat(p))
    rng = np.random.default_rng(3)
    want = {}
    for name, (cname, axes, wfile, steps, moe) in CASES.items():
        cfg = ref_config(cname)
        toks, lens, dec, active = _inputs(name, cfg, rng)
        np.savez(d / f"{name}_in.npz", toks=toks, lens=lens, steps=dec,
                 active=active)
        prefill, decode = _jax_forms(cfg, axes, moe)
        params = trees[wfile]
        lg, cache = prefill(params, tokens=jnp.asarray(toks),
                            prompt_lens=jnp.asarray(lens))
        want[f"{name}/prefill"] = np.asarray(lg)
        for i in range(steps):
            lg, cache = decode(params, tokens=jnp.asarray(dec[i][:, None]),
                               cache=cache, active=jnp.asarray(active[i]))
            want[f"{name}/step{i}"] = np.asarray(lg)
        want[f"{name}/k"] = np.asarray(cache.k)
        want[f"{name}/v"] = np.asarray(cache.v)
        want[f"{name}/lengths"] = np.asarray(cache.lengths)
        want[f"{name}/lens"] = lens
    import json
    _spawn_ranks(_RANK, 4, {"DIR": str(d), "CASES": json.dumps(CASES)},
                 timeout=110)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return want, ranks


def _members(name):
    return range(int(np.prod(list(CASES[name][1].values()))))


def _chunk(want, name, r, ranks, key="prefill"):
    sp = CASES[name][1]["sp"]
    my = int(ranks[r][f"{name}/coords"][0])
    full = want[f"{name}/{key}"]
    Sl = full.shape[1] // sp
    return full[:, my * Sl:(my + 1) * Sl], my, Sl


def _check_cache(want, ranks, name, tol=TOL):
    """Each rank's cache against the reference's at its sequence shard
    and its kv heads, over each row's committed slots (below its length).
    Past them the two may differ: the reference scatters a row's step
    into a shard that does not hold its slot at a negative local index,
    which JAX wraps from the end, into a slot no row trusts yet."""
    sp = CASES[name][1]["sp"]
    tp = CASES[name][1].get("tp", 1)
    lengths = want[f"{name}/lengths"]
    for r in _members(name):
        my, t = (int(c) for c in ranks[r][f"{name}/coords"])
        assert np.array_equal(ranks[r][f"{name}/lengths"], lengths)
        for kv in ("k", "v"):
            full = want[f"{name}/{kv}"]
            Sl, H = full.shape[2] // sp, full.shape[3] // tp
            ref = full[:, :, my * Sl:(my + 1) * Sl, t * H:(t + 1) * H]
            got = ranks[r][f"{name}/{kv}"]
            n = 0
            for b, length in enumerate(lengths):
                live = int(np.clip(length - my * Sl, 0, Sl))
                n += live
                if live:
                    _close(got[:, b, :live], ref[:, b, :live],
                           f"{name} cache {kv}, rank {r}, row {b}", tol)
            assert n, (name, r)


def _check_steps(want, ranks, name, tol=TOL):
    for i in range(CASES[name][3]):
        key = f"{name}/step{i}"
        _close(ranks[0][key], want[key], key, tol)
        for r in _members(name):
            assert ranks[r][key].tobytes() == ranks[0][key].tobytes(), \
                (key, r)


@pytest.mark.parametrize("name", ["sp2", "sp4"])
def test_ring_prefill_matches_the_jax_form(world, name):
    want, ranks = world
    for r in _members(name):
        ref, _, _ = _chunk(want, name, r, ranks)
        _close(ranks[r][f"{name}/prefill"], ref, f"{name} rank {r}")
    _check_cache(want, ranks, name)
    assert all(f"{name}/prefill" not in ranks[r]
               for r in range(4) if r not in _members(name))


def test_ring_prefill_ragged_rows_match_at_real_positions(world):
    want, ranks = world
    lens = want["ragged/lens"]
    for r in _members("ragged"):
        ref, my, Sl = _chunk(want, "ragged", r, ranks)
        got = ranks[r]["ragged/prefill"]
        for b, n in enumerate(lens):
            real = max(0, min(Sl, n - my * Sl))
            if real:
                _close(got[b, :real], ref[b, :real], f"ragged row {b}")


def test_sp_decode_with_zero_slot_shards_and_a_parked_row(world):
    want, ranks = world
    for r in _members("decode"):
        ref, _, _ = _chunk(want, "decode", r, ranks)
        _close(ranks[r]["decode/prefill"], ref, f"decode prefill {r}")
    _check_steps(want, ranks, "decode")
    _check_cache(want, ranks, "decode")
    assert list(want["decode/lengths"]) == [12 + 3, 24 + 2]


def test_ring_sp2_tp2_matches_the_jax_form(world):
    want, ranks = world
    for r in _members("tp"):
        ref, _, _ = _chunk(want, "tp", r, ranks)
        _close(ranks[r]["tp/prefill"], ref, f"tp prefill rank {r}")
    # The two tp ranks of a chunk return it bitwise alike.
    for a, b in ((0, 1), (2, 3)):
        assert ranks[a]["tp/prefill"].tobytes() == \
            ranks[b]["tp/prefill"].tobytes()
    _check_steps(want, ranks, "tp")
    _check_cache(want, ranks, "tp")
    assert ranks[0]["tp/k"].shape[3] == ref_config("tiny-tp").num_kv_heads // 2


def test_ring_sp2_ep2_moe_matches_the_jax_form(world):
    want, ranks = world
    for r in _members("ep"):
        ref, _, _ = _chunk(want, "ep", r, ranks)
        _close(ranks[r]["ep/prefill"], ref, f"ep prefill rank {r}")
    _check_steps(want, ranks, "ep")
    _check_cache(want, ranks, "ep")


def test_ring_int8_weights(world):
    want, ranks = world
    for r in _members("int8"):
        ref, _, _ = _chunk(want, "int8", r, ranks)
        _close(ranks[r]["int8/prefill"], ref, f"int8 prefill rank {r}",
               TOL_INT8)
    _check_steps(want, ranks, "int8", TOL_INT8)


@pytest.mark.parametrize("axes,moe,match", [
    (dict(dp=2, sp=2), False, "sp \\(x tp \\| x ep\\) only"),
    (dict(pp=2, sp=2), False, "sp \\(x tp \\| x ep\\) only"),
    (dict(sp=2, tp=2), True, "not tp"),
    (dict(ep=2, sp=2), False, "moe_ring_mlp_fn")])
def test_ring_refuses_what_the_reference_asserts(axes, moe, match):
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.llama import init_params
    from p2p_llm_chat_tpu_torch.parallel.mesh import Mesh, MeshConfig
    from p2p_llm_chat_tpu_torch.parallel.ring import ring_prefill as port
    cfg = get_config("tiny")
    params = init_params(cfg, 0, torch.float32, "cpu")
    fn = (lambda x, layers, li: x) if moe else None
    with pytest.raises(ValueError, match=match):
        port(params, cfg, torch.zeros((2, 16), dtype=torch.long),
             torch.full((2,), 16), Mesh.at(MeshConfig(**axes), 0),
             mlp_fn=fn)
