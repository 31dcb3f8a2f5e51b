"""The port's pipeline-parallel forms (p2p_llm_chat_tpu_torch/parallel/
pipeline.py: ``pp_prefill``, ``pp_decode_step``) on one world of two
spawned ranks at pp = 2 over gloo, against the JAX forms
(p2p_llm_chat_tpu/parallel/pipeline.py) on a pp = 2 mesh of the
conftest's fake CPU devices, on ``tiny``:

- prefill at 2 microbatches (B = 4, S = 16, ragged prompt lengths) on
  the reference's f32 weights carried across, each rank holding its
  stage (parallel/sharding.stage_layers): the logits and each stage's
  cache, and the ``last_only`` logits at each row's last prompt position;
- prefill then 3 decode steps with row 1 parked by ``active`` in every
  step (the logits of every row and the lengths);
- the same prefill on the reference's ``quantize_params`` int8 weights,
  which ride the stage cut (``q`` and ``s`` both cut on the layer axis);
- both ranks' logits bitwise equal (the last stage's, broadcast).

Tolerance: f32 within 1e-4 of max|value| (the same math in another
order); int8 within 1e-3 of max|value| (the scale applied at another
point of the product). The JAX side runs each form under ``jax.jit``
once. The world runs once for the whole file (a 90 s limit); its ranks
are killed on the way out. A mesh with any axis but ``pp`` is refused.
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
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.quant import quantize_params
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from p2p_llm_chat_tpu.parallel.mesh import make_mesh as ref_make_mesh
from p2p_llm_chat_tpu.parallel.pipeline import pp_decode_step, pp_prefill

pytestmark = pytest.mark.model
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4       # of max|value|: f32, the same math in another order
TOL_INT8 = 1e-3  # of max|value|: int8 weights, the scale applied elsewhere
STEPS = 3

_RANK = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.quant import QTensor
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh, sharding
from p2p_llm_chat_tpu_torch.parallel.pipeline import pp_decode_step, pp_prefill

d = os.environ["DIR"]
cfg = get_config("tiny")
assert distributed.init_distributed(join_timeout_s=60)
rank = torch.distributed.get_rank()
m = distributed.multihost_mesh(mesh.MeshConfig(pp=2), "cpu")


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


def stage(name):
    whole = tree(os.path.join(d, name))
    return sharding.stage_layers(whole, cfg, m, "cpu")


x = np.load(os.path.join(d, "inputs.npz"))
out = {}
with torch.no_grad():
    params = stage("weights.npz")
    toks, lens = torch.from_numpy(x["toks"]).long(), torch.from_numpy(x["lens"])
    lg, cache = pp_prefill(params, cfg, toks, lens, m, microbatches=2)
    out["prefill"] = lg.numpy()
    out["prefill_k"] = cache.k[:, :, :toks.shape[1]].numpy()
    out["prefill_v"] = cache.v[:, :, :toks.shape[1]].numpy()
    lg, _ = pp_prefill(params, cfg, toks, lens, m, microbatches=2,
                       last_only=True)
    out["last"] = lg.numpy()
    dtoks = torch.from_numpy(x["dtoks"]).long()
    dlens = torch.from_numpy(x["dlens"])
    lg, cache = pp_prefill(params, cfg, dtoks, dlens, m, microbatches=2)
    out["decode_prefill"] = lg.numpy()
    active = torch.from_numpy(x["active"])
    for i, nxt in enumerate(x["steps"]):
        lg, cache = pp_decode_step(params, cfg,
                                   torch.from_numpy(nxt).long()[:, None],
                                   cache, m, active=active)
        out[f"step{i}"] = lg.numpy()
    out["lengths"] = cache.lengths.numpy()
    out["decode_k"] = cache.k[:, :, :dtoks.shape[1]].numpy()
    qparams = stage("weights_int8.npz")
    lg, _ = pp_prefill(qparams, cfg, toks[:2, :8], lens[:2].clamp(max=8), m,
                       microbatches=2)
    out["int8"] = lg.numpy()
    out["sent_bytes"] = np.array(m.sent_bytes)
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX forms' results and both ranks' outputs, once per file."""
    d = tmp_path_factory.mktemp("pp_world")
    cfg = ref_config("tiny")
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    qparams = quantize_params(params)
    np.savez(d / "weights.npz", **_flat(params))
    np.savez(d / "weights_int8.npz", **_flat(qparams))
    rng = np.random.default_rng(0)
    B, S = 4, 16
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = rng.integers(S // 2, S + 1, (B,)).astype(np.int32)
    # Decode: prompts of 8 in a bucket of 12, row 1 parked every step.
    dB, dS, P = 2, 12, 8
    dtoks = np.zeros((dB, dS), np.int32)
    dtoks[:, :P] = rng.integers(0, cfg.vocab_size, (dB, P))
    dlens = np.full((dB,), P, np.int32)
    steps = rng.integers(3, cfg.vocab_size, (STEPS, dB)).astype(np.int32)
    active = np.array([True, False])
    np.savez(d / "inputs.npz", toks=toks, lens=lens, dtoks=dtoks,
             dlens=dlens, steps=steps, active=active)

    mesh = ref_make_mesh(RefMeshConfig(pp=2))
    prefill = jax.jit(functools.partial(pp_prefill, config=cfg, mesh=mesh,
                                        microbatches=2))
    decode = jax.jit(functools.partial(pp_decode_step, config=cfg,
                                       mesh=mesh))
    want = {}
    lg, cache = prefill(params, tokens=jnp.asarray(toks),
                        prompt_lens=jnp.asarray(lens))
    want["prefill"] = np.asarray(lg)
    want["prefill_k"] = np.asarray(cache.k)
    want["prefill_v"] = np.asarray(cache.v)
    lg, cache = prefill(params, tokens=jnp.asarray(dtoks),
                        prompt_lens=jnp.asarray(dlens))
    want["decode_prefill"] = np.asarray(lg)
    for i in range(STEPS):
        lg, cache = decode(params, tokens=jnp.asarray(steps[i][:, None]),
                           cache=cache, active=jnp.asarray(active))
        want[f"step{i}"] = np.asarray(lg)
    want["lengths"] = np.asarray(cache.lengths)
    want["decode_k"] = np.asarray(cache.k)
    lg, _ = prefill(qparams, tokens=jnp.asarray(toks[:2, :8]),
                    prompt_lens=jnp.asarray(np.minimum(lens[:2], 8)))
    want["int8"] = np.asarray(lg)
    want["lens"] = lens

    _spawn_ranks(_RANK, 2, {"DIR": str(d)}, timeout=90)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(2)]
    return want, ranks


def test_pp_prefill_at_two_microbatches_matches_the_jax_form(world):
    want, ranks = world
    _close(ranks[0]["prefill"], want["prefill"], "prefill")
    assert ranks[0]["prefill"].tobytes() == ranks[1]["prefill"].tobytes()
    # Each stage holds its layer of the cache.
    for r in range(2):
        _close(ranks[r]["prefill_k"], want["prefill_k"][r:r + 1],
               f"cache k, stage {r}")
        _close(ranks[r]["prefill_v"], want["prefill_v"][r:r + 1],
               f"cache v, stage {r}")
    # A prefill moved h [2, 16, 128] f32 from stage 0 to stage 1 twice.
    assert int(ranks[0]["sent_bytes"]) > 0
    assert int(ranks[1]["sent_bytes"]) == 0


def test_pp_prefill_last_only_gives_each_rows_last_prompt_position(world):
    want, ranks = world
    lens = want["lens"]
    last = want["prefill"][np.arange(len(lens)), lens - 1][:, None]
    _close(ranks[0]["last"], last, "last_only")
    assert ranks[0]["last"].tobytes() == ranks[1]["last"].tobytes()


def test_pp_decode_with_a_parked_row_matches_the_jax_form(world):
    want, ranks = world
    _close(ranks[0]["decode_prefill"], want["decode_prefill"],
           "decode's prefill")
    for i in range(STEPS):
        _close(ranks[0][f"step{i}"], want[f"step{i}"], f"step {i}")
        assert (ranks[0][f"step{i}"].tobytes()
                == ranks[1][f"step{i}"].tobytes()), i
    assert np.array_equal(ranks[0]["lengths"], want["lengths"])
    assert list(want["lengths"]) == [8 + STEPS, 8]
    for r in range(2):
        _close(ranks[r]["decode_k"], want["decode_k"][r:r + 1],
               f"decode cache k, stage {r}")


def test_pp_int8_weights_ride_the_stage_cut(world):
    want, ranks = world
    _close(ranks[0]["int8"], want["int8"], "int8 prefill", TOL_INT8)
    assert ranks[0]["int8"].tobytes() == ranks[1]["int8"].tobytes()


@pytest.mark.parametrize("axes", [dict(pp=2, sp=2), dict(pp=2, dp=2),
                                  dict(tp=2)])
def test_pp_refuses_a_mesh_with_other_axes(axes):
    import torch
    from p2p_llm_chat_tpu_torch.models.configs import get_config
    from p2p_llm_chat_tpu_torch.models.llama import init_params
    from p2p_llm_chat_tpu_torch.parallel.mesh import Mesh, MeshConfig
    from p2p_llm_chat_tpu_torch.parallel.pipeline import pp_prefill as port
    cfg = get_config("tiny")
    params = init_params(cfg, 0, torch.float32, "cpu")
    with pytest.raises(ValueError, match="pp only"):
        port(params, cfg, torch.zeros((2, 8), dtype=torch.long),
             torch.full((2,), 8), Mesh.at(MeshConfig(**axes), 0))
