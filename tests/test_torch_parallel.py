"""The port's parallel layer (p2p_llm_chat_tpu_torch/parallel/) against the
reference's on the CPU:

- ``AXES``, ``MeshConfig``, ``DEFAULT_RULES``, ``spec_for`` and
  ``tree_specs`` equal the reference's (a spec is a tuple in the port; the
  reference's ``PartitionSpec`` is a tuple too), on llama's and mixtral's
  ``param_axes``;
- for tp 2 and 4 (dp 2), each rank's ``shard_params`` slice of ``tiny-tp``
  and ``tiny-moe`` equals the reference's shard for that device
  (``addressable_shards`` on the conftest's fake CPU devices) wherever the
  port cuts (``tiny`` too); where the heads do not divide (``tiny``'s and
  ``tiny-moe``'s 2 kv heads at tp = 4) the layers stay whole while the vocabulary and experts are cut.
  A shard depends only on the rank's coordinates, so nothing is spawned;
- ``init_distributed`` is a no-op without env, the layout checks of
  ``multihost_mesh`` hold, and one process passes through to
  ``make_mesh`` (the counterparts of tests/test_distributed.py's
  single-process tests);
- the backend rule, and a 2-process gloo world (each rank its own process,
  60 s limit): gloo compute groups on the CPU, an all-reduce and an
  all-gather over ``tp`` and over ``dp``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import mixtral as ref_mixtral
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.parallel import mesh as ref_mesh
from p2p_llm_chat_tpu.parallel import sharding as ref_sharding
from p2p_llm_chat_tpu_torch.models import llama, mixtral
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh, sharding

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_axes_meshconfig_and_rules_equal_the_reference():
    assert mesh.AXES == ref_mesh.AXES
    for kw in ({}, {"dp": 2, "tp": 4}, {"dp": 3, "pp": 2, "ep": 2, "sp": 1,
                                        "tp": 2}):
        assert mesh.MeshConfig(**kw).size == ref_mesh.MeshConfig(**kw).size
    for n, tp in ((8, None), (8, 2), (4, 4), (6, 3)):
        assert (mesh.MeshConfig.for_devices(n, tp)
                == mesh.MeshConfig(**vars(ref_mesh.MeshConfig.for_devices(
                    n, tp))))
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    for axes in ((None, "embed", "heads"), ("vocab", "embed"),
                 (None, "experts", "embed", "expert_mlp"), (None, None),
                 ("batch", "seq", "act_heads", None)):
        assert sharding.spec_for(axes) == tuple(ref_sharding.spec_for(axes))
    with pytest.raises(KeyError, match="unknown logical axis"):
        sharding.spec_for(("nope",))


@pytest.mark.parametrize("name", ["tiny", "tiny-tp", "tiny-moe"])
def test_param_axes_and_tree_specs_equal_the_reference(name):
    fam, ref_fam = ((mixtral, ref_mixtral) if "moe" in name
                    else (llama, ref_llama))
    axes = fam.param_axes(get_config(name))
    assert axes == ref_fam.param_axes(ref_config(name))
    got = sharding.tree_specs(axes)
    want = jax.tree.map(tuple, ref_sharding.tree_specs(
        ref_fam.param_axes(ref_config(name))),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert got == want


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# Leaves the layer split cuts (tp over heads / kv heads / the dense FFN;
# mixtral's FFN leaves are expert stacks, cut over the experts).
_ATTN_LEAVES = {"layers/wq", "layers/wk", "layers/wv", "layers/wo"}
_FFN_LEAVES = {"layers/w_gate", "layers/w_up", "layers/w_down"}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["tiny", "tiny-tp", "tiny-moe"])
def test_each_ranks_shard_equals_the_references_device_shard(name, tp):
    rcfg, cfg = ref_config(name), get_config(name)
    ref_fam, fam = ((ref_mixtral, mixtral) if cfg.is_moe
                    else (ref_llama, llama))
    import jax.numpy as jnp
    rparams = ref_fam.init_params(rcfg, jax.random.PRNGKey(5),
                                  dtype=jnp.float32)
    mc = ref_mesh.MeshConfig(dp=2, tp=tp)
    rmesh = ref_mesh.make_mesh(mc)
    rsharded = _flat(ref_sharding.shard_params(
        rparams, ref_fam.param_axes(rcfg), rmesh))
    full = params_from_numpy(jax.tree.map(np.asarray, rparams),
                             device="cpu")
    full_flat = _flat(full)
    split = sharding.Split.of(cfg, mesh.Mesh.at(mesh.MeshConfig(dp=2, tp=tp),
                                                0))
    layers_whole = cfg.num_kv_heads % tp != 0
    assert split.layers == (1 if layers_whole else tp)
    assert split.vocab == tp
    assert split.experts == (tp if cfg.is_moe else 1)
    devs = np.asarray(rmesh.devices).reshape(2, tp)
    layer_leaves = _ATTN_LEAVES | (set() if cfg.is_moe else _FFN_LEAVES)
    n_cut = 0
    for rank in range(mc.size):
        m = mesh.Mesh.at(mesh.MeshConfig(dp=2, tp=tp), rank)
        got = _flat(sharding.shard_params(full, fam.param_axes(cfg), m,
                                          "cpu", config=cfg))
        dev = devs[m.coords["dp"], m.coords["tp"]]
        for key, arr in rsharded.items():
            ref = next(np.asarray(s.data) for s in arr.addressable_shards
                       if s.device == dev)
            mine = got[key].numpy()
            if key in layer_leaves and layers_whole:
                # The heads do not divide: whole on every rank, where the
                # reference cuts inside a head.
                assert np.array_equal(mine, full_flat[key].numpy()), key
                continue
            assert mine.shape == ref.shape, (key, mine.shape, ref.shape)
            assert np.array_equal(mine, ref), (key, rank)
            n_cut += mine.shape != full_flat[key].shape
    assert n_cut > 0


@pytest.mark.parametrize("name", ["tiny-tp", "tiny-moe"])
def test_shard_model_fuses_each_ranks_blocks(name):
    """A rank's fused ``wqkv`` is ``[q_r | k_r | v_r]`` (the reference's
    per-device block of its interleaved layout); mixtral's expert stacks
    stay separate under a mesh; an unfused tree and the port's fused one
    give the same shard."""
    cfg = get_config(name)
    fam = mixtral if cfg.is_moe else llama
    full = fam.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    m = mesh.Mesh.at(mesh.MeshConfig(tp=2), 1)
    got = sharding.shard_model(full, cfg, m, "cpu")
    Q, KV, D = cfg.q_dim, cfg.kv_dim, cfg.head_dim
    qkv = full["layers"]["wqkv"]
    h, kvh = cfg.num_heads // 2, cfg.num_kv_heads // 2
    want = torch.cat([qkv[..., h * D:Q], qkv[..., Q + kvh * D:Q + KV],
                      qkv[..., Q + KV + kvh * D:]], dim=-1)
    assert torch.equal(got["layers"]["wqkv"], want)
    if cfg.is_moe:
        assert "wgu_e" not in got["layers"]
        assert got["layers"]["w_gate"].shape[1] == cfg.num_experts // 2
    else:
        E = cfg.intermediate_size
        gu = full["layers"]["wgu"]
        assert torch.equal(got["layers"]["wgu"], torch.cat(
            [gu[..., E // 2:E], gu[..., E + E // 2:]], dim=-1))
    again = sharding.shard_model(fam.unfuse_params(full, cfg), cfg, m, "cpu")
    for k, v in got["layers"].items():
        assert torch.equal(v, again["layers"][k]), k
    # Nothing cut: the tree passes through (one rank).
    assert sharding.shard_model(full, cfg, mesh.Mesh.at(
        mesh.MeshConfig(), 0), "cpu")["layers"]["wqkv"] is qkv


def test_shard_params_refuses_quantized_leaves():
    cfg = get_config("tiny-tp")
    q = llama.init_params_quantized(cfg, seed=0, quant="int8",
                                    device="cpu")
    with pytest.raises(TypeError, match="plain tensors"):
        sharding.shard_params({"wo": q["layers"]["wo"]},
                              {"wo": (None, "heads", "embed")},
                              mesh.Mesh.at(mesh.MeshConfig(tp=2), 0),
                              "cpu", config=cfg)


def test_single_process_fallbacks(monkeypatch):
    for k in ("SERVE_COORDINATOR", "JAX_COORDINATOR", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False
    m = distributed.multihost_mesh(mesh.MeshConfig())
    assert m.size == 1 and m.groups == {} and m.backend is None
    with pytest.raises(ValueError, match="mesh needs 4 ranks, have 1"):
        distributed.multihost_mesh(mesh.MeshConfig(dp=2, tp=2))
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        distributed.init_distributed()


def test_multihost_mesh_validation():
    """The reference's checks: the mesh covers the world, and a replica
    (a dp row) does not straddle a host."""
    with pytest.raises(ValueError, match="multiple of host count"):
        distributed.check_layout(mesh.MeshConfig(dp=1, tp=8), 8, 2)
    with pytest.raises(ValueError, match="world size"):
        distributed.check_layout(mesh.MeshConfig(dp=2, tp=2), 8, 2)
    distributed.check_layout(mesh.MeshConfig(dp=2, tp=4), 8, 2)
    distributed.check_layout(mesh.MeshConfig(dp=1, tp=2), 2, 1)


def test_multihost_mesh_single_process_passthrough():
    m = distributed.multihost_mesh(mesh.MeshConfig())
    assert m.shape == {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1}
    assert m.coords == {a: 0 for a in mesh.AXES}
    assert sharding.Split.of(get_config("tiny"), m) is None


@pytest.mark.parametrize("world,want", [
    ([("h", "cuda:0"), ("h", "cuda:1")], "nccl"),
    ([("a", "cuda:0"), ("b", "cuda:0")], "nccl"),
    ([("h", "cuda:0"), ("h", "cuda:0")], "gloo"),
    ([("h", "cuda:0")], "nccl"),
    ([("h", "cpu"), ("h", "cpu")], "gloo"),
    ([("h", "cpu")], "gloo")])
def test_backend_rule(world, want):
    assert distributed.choose_backend(world) == want


def test_mesh_coordinates_put_tp_innermost():
    cfg = mesh.MeshConfig(dp=2, tp=2)
    assert [(mesh.Mesh.at(cfg, r).coords["dp"],
             mesh.Mesh.at(cfg, r).coords["tp"]) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    m = mesh.Mesh.at(mesh.MeshConfig(ep=2, tp=2), 3)
    assert m.index(("ep", "tp")) == 3 and m.span(("ep", "tp")) == 4
    assert m.group("dp") is None


_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import torch
torch.set_num_threads(1)
from p2p_llm_chat_tpu_torch.parallel import distributed, mesh
assert distributed.init_distributed()
rank = torch.distributed.get_rank()
tp = distributed.multihost_mesh(mesh.MeshConfig(tp=2), "cpu")
dp = mesh.make_mesh(mesh.MeshConfig(dp=2))
x = torch.full((2, 3), float(rank + 1))
out = {"rank": rank, "backend": tp.backend, "dp_backend": dp.backend,
       "tp_coords": tp.coords["tp"], "dp_coords": dp.coords["dp"],
       "tp_sum": tp.all_reduce(x.clone(), "tp").tolist(),
       "dp_sum": dp.all_reduce(x.clone(), "dp").tolist(),
       "tp_gather": tp.all_gather(x[:1] * 10 + rank, "tp", dim=-1).tolist(),
       "dp_gather": dp.all_gather(x[:1], "dp", dim=0).tolist(),
       "ms": tp.take_collective_ms() >= 0}
torch.distributed.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world_reduces_over_tp_and_dp():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, REPO=REPO, PYTHONPATH=REPO,
                   SERVE_COORDINATOR=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   SERVE_DEVICE="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.monotonic() + 60
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.5, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    res = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        res.append(json.loads(out.split("RESULT ", 1)[1].splitlines()[0]))
    for r in res:
        assert r["backend"] == r["dp_backend"] == "gloo"
        assert r["tp_coords"] == r["dp_coords"] == r["rank"]
        assert r["tp_sum"] == r["dp_sum"] == [[3.0] * 3] * 2
        assert r["tp_gather"] == [[10.0] * 3 + [21.0] * 3]
        assert r["dp_gather"] == [[1.0] * 3, [2.0] * 3]
        assert r["ms"]
