"""The tensor-parallel forms of the port's llama and mixtral (the ``mesh=``
path of ``prefill(last_only=True)`` into a dense ``KVCache``,
``decode_step(active=)`` and ``embed_pooled``) on two spawned ranks at
tp = 2 over gloo, against the JAX forms on a tp = 2 mesh of the
conftest's fake CPU devices, on the reference's f32 weights carried
across (numpy -> each rank's shard by parallel/sharding.shard_model).

- ``tiny-tp`` llama (heads, kv heads, FFN and vocabulary cut), the same
  with a tied lm_head (``embed.T``: each rank's embedding rows are its
  logit columns) and ``tiny-moe`` mixtral (heads, vocabulary and the 4
  experts cut; the router whole);
- a 2-row prefill, three decode steps with row 1 parked by ``active`` in
  the second, and the pooled embeddings, each within 1e-4 × max|value|
  of the JAX forms' (f32 on both sides; the sums over the shards add in
  another order);
- rank 0's and rank 1's logits and embeddings bitwise equal (gathered
  and reduced over the same group);
- the cache each rank holds is its half of the kv heads, and the same
  values as the reference's cache at those heads.

Each test spawns its two ranks with a 60 s limit and kills them on the
way out.
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
from p2p_llm_chat_tpu.models.llama import KVCache as RefCache
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig, make_mesh
from p2p_llm_chat_tpu.parallel.sharding import shard_params

pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4       # of max|value|: f32 forms, shard sums in another order

_RANK = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.llama import KVCache
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh, sharding

d = os.environ["DIR"]
cfg = get_config(os.environ["CFG"])
if os.environ.get("TIED"):
    cfg = cfg.with_(tie_embeddings=True)
fam = family_for(cfg)
assert distributed.init_distributed()
rank = torch.distributed.get_rank()
m = distributed.multihost_mesh(mesh.MeshConfig(tp=2), "cpu")
w = np.load(os.path.join(d, "weights.npz"))
tree = {}
for k in w.files:
    node = tree
    *path, leaf = k.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = torch.from_numpy(w[k])
params = sharding.shard_model(tree, cfg, m, "cpu")
x = np.load(os.path.join(d, "inputs.npz"))
toks, lens = torch.from_numpy(x["toks"]).long(), torch.from_numpy(x["lens"])
B = toks.shape[0]
cache = KVCache.create(cfg, B, int(x["max_seq"]), dtype=torch.float32,
                       device="cpu", mesh=m)
out = {}
with torch.no_grad():
    lg, cache = fam.prefill(params, cfg, toks, lens, last_only=True,
                            cache=cache, mesh=m)
    out["prefill"] = lg.numpy()
    for i, (nxt, act) in enumerate(zip(x["steps"], x["active"])):
        lg, cache = fam.decode_step(params, cfg,
                                    torch.from_numpy(nxt).long()[:, None],
                                    cache, torch.from_numpy(act), mesh=m)
        out[f"step{i}"] = lg.numpy()
    out["lengths"] = cache.lengths.numpy()
    out["cache_k"] = cache.k[:, :, :int(x["max_seq"])].numpy()
    out["embed"] = fam.embed_pooled(params, cfg, toks, lens, mesh=m).numpy()
torch.distributed.destroy_process_group()
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
    return {prefix[:-1]: np.asarray(tree)}


def _spawn_ranks(code: str, n: int, env_extra: dict, timeout: float = 60):
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


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name,tied", [("tiny-tp", False),
                                       ("tiny-moe", False),
                                       ("tiny-tp", True)],
                         ids=["tiny-tp", "tiny-moe", "tiny-tp-tied"])
def test_tp2_forms_match_the_sharded_jax_forms(name, tied, tmp_path):
    rcfg = ref_config(name).with_(tie_embeddings=tied)
    fam = ref_mixtral if rcfg.is_moe else ref_llama
    rparams = fam.init_params(rcfg, jax.random.PRNGKey(11),
                              dtype=jnp.float32)
    np.savez(tmp_path / "weights.npz", **_flat(rparams))
    mesh = make_mesh(MeshConfig(tp=2))
    sharded = shard_params(rparams, fam.param_axes(rcfg), mesh)

    rng = np.random.default_rng(7)
    B, S, max_seq = 2, 16, 64
    lens = np.array([11, 16], np.int32)
    toks = rng.integers(3, rcfg.vocab_size, size=(B, S)).astype(np.int32)
    # Token ids at the vocabulary shards' edges (256 = rank 1's first).
    toks[0, :4] = [255, 256, 0, rcfg.vocab_size - 1]
    steps = rng.integers(3, rcfg.vocab_size, size=(3, B)).astype(np.int32)
    steps[0] = [255, 256]
    active = np.array([[True, True], [True, False], [True, True]])
    np.savez(tmp_path / "inputs.npz", toks=toks, lens=lens, steps=steps,
             active=active, max_seq=max_seq)

    prefill = jax.jit(functools.partial(fam.prefill, config=rcfg, mesh=mesh,
                                        last_only=True))
    decode = jax.jit(functools.partial(fam.decode_step, config=rcfg,
                                       mesh=mesh))
    cache = RefCache.create(rcfg, B, max_seq, dtype=jnp.float32)
    want = {}
    lg, cache = prefill(sharded, tokens=jnp.asarray(toks),
                        prompt_lens=jnp.asarray(lens), cache=cache)
    want["prefill"] = np.asarray(lg)
    for i in range(3):
        lg, cache = decode(sharded, tokens=jnp.asarray(steps[i][:, None]),
                           cache=cache, active=jnp.asarray(active[i]))
        want[f"step{i}"] = np.asarray(lg)
    want["lengths"] = np.asarray(cache.lengths)
    ref_k = np.asarray(cache.k)
    want["embed"] = np.asarray(jax.jit(functools.partial(
        fam.embed_pooled, config=rcfg, mesh=mesh))(
            sharded, tokens=jnp.asarray(toks), lens=jnp.asarray(lens)))

    _spawn_ranks(_RANK, 2, {"DIR": str(tmp_path), "CFG": name,
                            "TIED": "1" if tied else ""})
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for key in ("prefill", "step0", "step1", "step2", "embed"):
        assert ranks[0][key].shape == want[key].shape, key
        _close(ranks[0][key], want[key], key)
        assert ranks[0][key].tobytes() == ranks[1][key].tobytes(), key
    assert np.array_equal(ranks[0]["lengths"], want["lengths"])
    assert list(want["lengths"]) == [11 + 3, 16 + 2]
    kv = rcfg.num_kv_heads // 2
    for r in range(2):
        k = ranks[r]["cache_k"]
        assert k.shape[3] == kv
        _close(k, ref_k[:, :, :, r * kv:(r + 1) * kv], f"cache rank {r}")
