"""What a tensor-parallel rank holds of a quantized model, against the
reference: the reference quantizes the sharded GLOBAL arrays
(``quantize_params(shard_params(params, axes, mesh), mesh)``), so a
row-cut leaf's scale reduces over every row; the port quantizes each leaf
whole and then cuts it (parallel/sharding.cut_leaf), whether it shards a
whole tree (``shard_model``), draws one a layer at a time
(``init_params_quantized(mesh=)``) or loads a checkpoint a layer at a
time (models/weights.load_checkpoint_streaming).

- ``tiny-tp`` at tp = 2, int8 and int4 (the reference's f32 weights
  carried across): each rank's fused leaves equal, bitwise, the
  reference's addressable shards on that rank's device — int8 bytes and
  scales; int4 column-cut bytes and scales; an int4 row-cut leaf's
  logical rows (the reference's split-half packed bytes of a row shard are
  not the rank's rows, so the values are compared unpacked) with its
  scales cut by whole groups, or kept whole where the cut falls inside a
  group (``wo``: one group of 128 rows);
- ``init_params_quantized(mesh=)`` (llama and mixtral, bf16 / int8 /
  int4) equals ``shard_model`` of the whole tree drawn from the same seed;
- ``load_checkpoint_streaming(path, mesh)`` on a tiny safetensors
  directory gives each rank the same shard as ``shard_model`` of the one-
  card load, bf16 and int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models import quant as ref_quant
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.parallel.mesh import MeshConfig as RefMeshConfig
from p2p_llm_chat_tpu.parallel.mesh import make_mesh as ref_make_mesh
from p2p_llm_chat_tpu.parallel.sharding import shard_params as ref_shard
from p2p_llm_chat_tpu_torch.models import llama, mixtral, weights
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.quant import (QTensor, QTensor4,
                                                 quantize_params, unpack4)
from p2p_llm_chat_tpu_torch.parallel import mesh, sharding
from tests.test_torch_weights import (random_hf_tensors, tiny_cfg,
                                      write_hf_dir)

torch.set_num_threads(2)
pytestmark = pytest.mark.model


def _rank_mesh(r: int, tp: int = 2):
    return mesh.Mesh.at(mesh.MeshConfig(tp=tp), r)


def _shard_on(leaf, device) -> np.ndarray:
    """The reference leaf's addressable shard on ``device``."""
    got = [s.data for s in leaf.addressable_shards if s.device == device]
    assert len(got) == 1
    return np.array(got[0])


@pytest.fixture(scope="module")
def ref_tree():
    cfg = ref_config("tiny-tp")
    return cfg, ref_llama.init_params(cfg, jax.random.PRNGKey(5),
                                      dtype=jnp.float32)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_each_ranks_quantized_shard_is_the_references(ref_tree, mode):
    rcfg, rparams = ref_tree
    devices = jax.devices()[:2]
    rmesh = ref_make_mesh(RefMeshConfig(tp=2), devices=devices)
    try:
        want = ref_quant.quantize_params(
            ref_shard(rparams, ref_llama.param_axes(rcfg), rmesh),
            mesh=rmesh, mode=mode)
    finally:
        ref_quant.set_mm_impl("auto")
    cfg = get_config("tiny-tp")
    whole = quantize_params(params_from_numpy(
        jax.tree.map(np.asarray, rparams), device="cpu"), mode=mode)
    wl = want["layers"]
    for r, dev in enumerate(devices):
        got = sharding.shard_model(whole, cfg, _rank_mesh(r), "cpu")
        gl = got["layers"]

        def cols(*names, part):
            return np.concatenate([_shard_on(getattr(wl[n], part), dev)
                                   for n in names], axis=-1)
        for fused, names in (("wqkv", ("wq", "wk", "wv")),
                             ("wgu", ("w_gate", "w_up"))):
            assert np.array_equal(gl[fused].q.numpy(),
                                  cols(*names, part="q")), (fused, r)
            assert np.array_equal(gl[fused].s.numpy(),
                                  cols(*names, part="s")), (fused, r)
        for name in ("lm_head",):
            assert np.array_equal(got[name].q.numpy(),
                                  _shard_on(want[name].q, dev)), (name, r)
            assert np.array_equal(got[name].s.numpy(),
                                  _shard_on(want[name].s, dev)), (name, r)
        for name in ("wo", "w_down"):
            leaf, ref = gl[name], wl[name]
            s_ref = _shard_on(ref.s, dev)
            assert np.array_equal(leaf.s.numpy(), s_ref), (name, r)
            if mode == "int8":
                assert isinstance(leaf, QTensor)
                assert np.array_equal(leaf.q.numpy(),
                                      _shard_on(ref.q, dev)), (name, r)
                assert leaf.s.shape == np.asarray(ref.s).shape  # whole
                continue
            assert isinstance(leaf, QTensor4)
            full = unpack4(torch.from_numpy(np.asarray(ref.q)))
            K = full.shape[-2] // 2
            assert torch.equal(unpack4(leaf.q),
                               full[..., r * K:(r + 1) * K, :]), (name, r)
            # wo's single group spans both ranks: its scale stays whole;
            # w_down's two groups are cut one a rank.
            ng = np.asarray(ref.s).shape[-2]
            assert leaf.s.shape[-2] == (1 if ng == 1 else ng // 2), name
        assert torch.equal(got["embed"], torch.from_numpy(
            _shard_on(want["embed"], dev)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, (QTensor, QTensor4)):
            out[f"{prefix}{k}.q"], out[f"{prefix}{k}.s"] = v.q, v.s
        else:
            out[prefix + k] = v
    return out


def _assert_same(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (what, sorted(g), sorted(w))
    for k in g:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), \
            (what, k)


@pytest.mark.parametrize("name", ["tiny-tp", "tiny-moe"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_layer_at_a_time_init_is_the_cut_of_the_whole(name, quant):
    cfg = get_config(name)
    fam = mixtral if cfg.is_moe else llama
    whole = fam.init_params_quantized(cfg, seed=3, quant=quant,
                                      dtype=torch.float32, device="cpu")
    for r in range(2):
        m = _rank_mesh(r)
        got = fam.init_params_quantized(cfg, seed=3, quant=quant,
                                        dtype=torch.float32, device="cpu",
                                        mesh=m)
        split = sharding.Split.of(cfg, m)
        want = {k: (sharding.cut_leaf(k, v, split) if k != "layers" else
                    {n: sharding.cut_leaf(n, w, split, stacked=True)
                     for n, w in v.items()})
                for k, v in whole.items()}
        _assert_same(got, want, (name, quant, r))
        if quant:
            _assert_same(got, sharding.shard_model(whole, cfg, m, "cpu"),
                         (name, quant, r, "shard_model"))
        kv = got["layers"]["wqkv"]
        q = kv.q if quant else kv
        assert q.shape[-1] == (cfg.q_dim + 2 * cfg.kv_dim) // 2


@pytest.mark.parametrize("quant", ["", "int8"])
def test_streaming_load_gives_each_rank_its_shard(tmp_path, quant):
    cfg = tiny_cfg()
    d = write_hf_dir(tmp_path / "ckpt", random_hf_tensors(cfg, seed=4), cfg,
                     dtype=torch.float32)
    if quant:
        whole, _ = weights.load_checkpoint_quantized(d, quant=quant,
                                                     device="cpu")
    else:
        whole, _ = weights.load_checkpoint(d, device="cpu")
    for r in range(2):
        m = _rank_mesh(r)
        got, gcfg = weights.load_checkpoint_streaming(d, mesh=m, quant=quant,
                                                      device="cpu")
        assert gcfg.num_kv_heads == cfg.num_kv_heads
        _assert_same(got, sharding.shard_model(whole, cfg, m, "cpu"),
                     (quant, r))
        assert got["embed"].shape[0] == cfg.vocab_size // 2
