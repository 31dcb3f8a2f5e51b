"""The port's checkpoint path against the reference's and the
``safetensors`` package on the same files:

- models/safetensors_io (the port's own reader) against
  ``safetensors.torch`` on every dtype it maps, and its refusals of
  malformed headers;
- ``config_from_hf_json`` field by field against the reference's on
  ``transformers``-written llama (llama3 rope scaling, a list of eos ids)
  and Mixtral (``"head_dim": null``) directories;
- ``load_checkpoint`` (bf16) and ``load_checkpoint_quantized`` (int8 and
  int4) for tiny llama and Mixtral checkpoints in f32 and bf16 shards,
  sharded with an index, BITWISE against the reference's loaders (carried
  across with models/convert.params_from_numpy);
- the KeyError, FileNotFoundError, identity-mismatch ValueError,
  UnsupportedForQuantizedLoad and native-Orbax refusals.

The helpers that write a tree as an HF directory (the inverse of
``_reverse_name_map``) serve the other checkpoint tests too.
"""

import dataclasses
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import weights as ref_weights
from p2p_llm_chat_tpu_torch.models import weights
from p2p_llm_chat_tpu_torch.models.configs import ModelConfig
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.models.quant import QTensor, QTensor4
from p2p_llm_chat_tpu_torch.models.safetensors_io import (
    SafetensorsError, SafetensorsFile, read_header)

safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)
pytestmark = pytest.mark.model


# -- writing HF directories ----------------------------------------------------

def hf_config_json(cfg: ModelConfig) -> dict:
    """An HF config.json for ``cfg`` (llama or Mixtral architecture)."""
    out = {
        "architectures": ["MixtralForCausalLM" if cfg.is_moe
                          else "LlamaForCausalLM"],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": list(cfg.eos_token_ids),
    }
    rs = cfg.rope_scaling
    if rs is not None:
        out["rope_scaling"] = {
            "rope_type": "llama3", "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position}
    if cfg.is_moe:
        out.update(num_local_experts=cfg.num_experts,
                   num_experts_per_tok=cfg.num_experts_per_tok)
    return out


def _np(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def hf_tensors_from_tree(tree: dict, cfg: ModelConfig) -> dict:
    """HF name -> ``[out, in]`` tensor for a plain (unquantized) tree of
    the port's or the reference's layout, fused or not (the inverse of
    ``_reverse_name_map``)."""
    layers = {k: _np(v) for k, v in tree["layers"].items()}
    if "wqkv" in layers:
        q, kv = cfg.q_dim, cfg.kv_dim
        wqkv = layers.pop("wqkv")
        layers.update(wq=wqkv[..., :q], wk=wqkv[..., q:q + kv],
                      wv=wqkv[..., q + kv:])
    gu = layers.pop("wgu", None)
    if gu is None:
        gu = layers.pop("wgu_e", None)
    if gu is not None:
        F = cfg.intermediate_size
        layers.update(w_gate=gu[..., :F], w_up=gu[..., F:])
    out = {}
    for name, (path, li, e, tr) in weights._reverse_name_map(cfg).items():
        t = (_np(tree[path[0]]) if li is None else
             layers[path[1]][li] if e is None else layers[path[1]][li, e])
        out[name] = (t.T if tr else t).contiguous()
    return out


def write_hf_dir(d, tensors: dict, cfg: ModelConfig, dtype=torch.bfloat16,
                 n_shards: int = 2, tokenizer: str = None) -> str:
    """config.json + ``n_shards`` safetensors shards of ``tensors`` in
    ``dtype`` (names split in sorted order, as the HF sharder does) + the
    index, and ``tokenizer`` copied in as tokenizer.json."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config_json(cfg), f)
    names = sorted(tensors)
    per = -(-len(names) // n_shards)
    weight_map = {}
    for s in range(n_shards):
        fname = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        chunk = {n: tensors[n].to(dtype).contiguous()
                 for n in names[s * per:(s + 1) * per]}
        safetensors_torch.save_file(chunk, os.path.join(d, fname))
        weight_map.update({n: fname for n in chunk})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    if tokenizer is not None:
        with open(tokenizer) as src, \
                open(os.path.join(d, "tokenizer.json"), "w") as dst:
            dst.write(src.read())
    return str(d)


def tiny_cfg(moe: bool = False, tie: bool = False) -> ModelConfig:
    """Widths at which every int4 leaf groups (contractions 128 and 256)."""
    return ModelConfig(
        name="tiny-ckpt", vocab_size=256, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, max_seq_len=256, rope_theta=10000.0,
        tie_embeddings=tie, num_experts=4 if moe else 0,
        num_experts_per_tok=2 if moe else 0, bos_token_id=1,
        eos_token_ids=(2,))


def random_hf_tensors(cfg: ModelConfig, seed: int = 0) -> dict:
    """HF-layout f32 tensors of ``cfg`` from a seeded numpy generator
    (norms around 1, projections at the reference's init scale)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (path, li, e, tr) in weights._reverse_name_map(cfg).items():
        key = path[-1]
        H, F = cfg.hidden_size, cfg.intermediate_size
        shape = {"embed": (cfg.vocab_size, H), "final_norm": (H,),
                 "lm_head": (H, cfg.vocab_size), "attn_norm": (H,),
                 "mlp_norm": (H,), "wq": (H, cfg.q_dim),
                 "wk": (H, cfg.kv_dim), "wv": (H, cfg.kv_dim),
                 "wo": (cfg.q_dim, H), "router": (H, cfg.num_experts),
                 "w_gate": (H, F), "w_up": (H, F), "w_down": (F, H)}[key]
        if key.endswith("norm"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * (1.0 if key == "embed"
                                              else H ** -0.5)
        t = torch.from_numpy(a.astype(np.float32))
        out[name] = (t.T if tr else t).contiguous()
    return out


# -- the reader ---------------------------------------------------------------

_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
           torch.uint8, torch.int32, torch.int64]


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
def test_reader_matches_safetensors_on_every_dtype(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    base = torch.randn((5, 7), generator=g) * 50
    tensors = {
        "a.weight": base.to(dtype),
        "b.scalar": torch.tensor(3).to(dtype),
        "c.empty": torch.zeros((0, 4), dtype=dtype),
        "d.vec": torch.arange(11).to(dtype),
    }
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    want = safetensors_torch.load_file(path)
    with SafetensorsFile(path) as f:
        assert sorted(f.keys()) == sorted(want)
        for name, w in want.items():
            got = f.get(name)
            assert got.dtype == w.dtype and got.shape == w.shape, name
            assert torch.equal(got.view(-1).view(torch.uint8),
                               w.reshape(-1).view(torch.uint8)), name


def test_reader_views_the_mapping_without_copies(tmp_path):
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file({"w": torch.arange(64, dtype=torch.int32)},
                                path)
    f = SafetensorsFile(path)
    a, b = f.get("w"), f.get("w")
    assert a.data_ptr() == b.data_ptr()        # one mapping, no copy
    a[0] = 7                                   # private: the file keeps 0
    assert safetensors_torch.load_file(path)["w"][0] == 0


def _raw_file(path, header: dict, data: bytes, n: int = None) -> None:
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h) if n is None else n) + h + data)


@pytest.mark.parametrize("header,data,match", [
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
      "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}},
     bytes(12), "overlap"),
    ({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}},
     bytes(8), "outside"),
    ({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
     bytes(8), "needs 12"),
    ({"a": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}},
     bytes(8), "unsupported"),
], ids=["overlap", "out-of-file", "size", "dtype"])
def test_reader_rejects_malformed_entries(tmp_path, header, data, match):
    path = str(tmp_path / "bad.safetensors")
    _raw_file(path, header, data)
    with pytest.raises(SafetensorsError, match=match):
        read_header(path)


def test_reader_rejects_a_header_longer_than_the_file(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    _raw_file(path, {}, b"", n=1 << 20)
    with pytest.raises(SafetensorsError, match="does not fit"):
        SafetensorsFile(path)


# -- config.json ----------------------------------------------------------------

def _hf_llama_config():
    return transformers.LlamaConfig(
        vocab_size=320, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64},
        bos_token_id=300, eos_token_id=[301, 305], tie_word_embeddings=False)


def _hf_mixtral_config():
    return transformers.MixtralConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=512, rope_theta=1e6, bos_token_id=1,
        eos_token_id=2)


@pytest.mark.parametrize("make", [_hf_llama_config, _hf_mixtral_config],
                         ids=["llama3", "mixtral"])
def test_config_from_hf_json_matches_reference(tmp_path, make):
    hf = make()
    path = str(tmp_path / "config.json")
    hf.to_json_file(path)
    got = dataclasses.asdict(weights.config_from_hf_json(path))
    want = dataclasses.asdict(ref_weights.config_from_hf_json(path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    if make is _hf_mixtral_config:
        assert json.load(open(path)).get("head_dim", "absent") in (None,
                                                                   "absent")
        assert got["head_dim"] == 32 and got["num_experts"] == 4
    else:
        assert got["rope_scaling"]["original_max_position"] == 64
        assert got["eos_token_ids"] == (301, 305)


# -- the loaders, bitwise against the reference's --------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def assert_trees_bitwise(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_trees_bitwise(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (QTensor, QTensor4)):
        assert type(got) is type(want), path
        assert_trees_bitwise(got.q, want.q, path + ".q")
        assert_trees_bitwise(got.s, want.s, path + ".s")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(_bits(got), _bits(want)), path


def _ref_tree(tree) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """(family, shard dtype) -> an HF directory, sharded with an index."""
    out = {}
    for moe in (False, True):
        cfg = tiny_cfg(moe=moe)
        tensors = random_hf_tensors(cfg, seed=1 + moe)
        for dt in (torch.float32, torch.bfloat16):
            d = tmp_path_factory.mktemp(f"{'moe' if moe else 'llama'}-"
                                        f"{str(dt)[6:]}")
            out[("mixtral" if moe else "llama", dt)] = write_hf_dir(
                d, tensors, cfg, dtype=dt, n_shards=3)
    return out


_CASES = [(fam, dt) for fam in ("llama", "mixtral")
          for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("fam,dt", _CASES,
                         ids=[f"{f}-{str(d)[6:]}" for f, d in _CASES])
def test_load_checkpoint_bf16_matches_reference(ckpt_dirs, fam, dt):
    d = ckpt_dirs[(fam, dt)]
    got, cfg = weights.load_checkpoint(d, device="cpu")
    want, ref_cfg = ref_weights.load_checkpoint(d)
    assert cfg.num_layers == ref_cfg.num_layers == 2
    assert_trees_bitwise(got, _ref_tree(want))
    assert got["embed"].dtype == torch.bfloat16
    # The oracle agrees with the loader.
    state = {n: safetensors_torch.load_file(os.path.join(d, f))[n]
             for f in sorted(os.listdir(d)) if f.endswith(".safetensors")
             for n in safetensors_torch.load_file(os.path.join(d, f))}
    assert_trees_bitwise(weights.convert_hf_state_dict(state, cfg), got)


_QCASES = [(fam, dt, q) for fam, dt in _CASES for q in ("int8", "int4")]


@pytest.mark.parametrize("fam,dt,quant", _QCASES,
                         ids=[f"{f}-{str(d)[6:]}-{q}" for f, d, q in _QCASES])
def test_load_checkpoint_quantized_matches_reference(ckpt_dirs, fam, dt,
                                                     quant):
    d = ckpt_dirs[(fam, dt)]
    stats: dict = {}
    got, cfg = weights.load_checkpoint_quantized(d, quant=quant,
                                                 device="cpu", stats=stats)
    want, _ = ref_weights.load_checkpoint_quantized(d, quant=quant)
    assert_trees_bitwise(got, _ref_tree(want))
    layers = got["layers"]
    assert ("wgu_e" in layers) == (fam == "mixtral")
    kind = QTensor4 if quant == "int4" else QTensor
    assert all(isinstance(layers[k], kind) for k in ("wqkv", "wo", "w_down"))
    assert isinstance(got["lm_head"], kind)
    assert len(stats["layers_s"]) == cfg.num_layers
    assert stats["total_s"] > 0


def test_quantized_load_equals_bf16_load_quantized_then_fused(ckpt_dirs):
    """The loader's own contract, on the port alone: streaming equals
    load_checkpoint -> quantize_params -> fuse_params."""
    from p2p_llm_chat_tpu_torch.models import llama, mixtral
    from p2p_llm_chat_tpu_torch.models.quant import quantize_params
    for fam, quant in (("llama", "int4"), ("mixtral", "int8")):
        d = ckpt_dirs[(fam, torch.float32)]
        base, _ = weights.load_checkpoint(d, device="cpu")
        fuse = (mixtral if fam == "mixtral" else llama).fuse_params
        want = fuse(quantize_params(base, mode=quant))
        got, _ = weights.load_checkpoint_quantized(d, quant=quant,
                                                   device="cpu")
        assert_trees_bitwise(got, want)


def test_tied_config_has_no_lm_head(tmp_path):
    cfg = tiny_cfg(tie=True)
    d = write_hf_dir(tmp_path, random_hf_tensors(cfg), cfg)
    got, _ = weights.load_checkpoint_quantized(d, device="cpu")
    want, _ = ref_weights.load_checkpoint_quantized(d)
    assert "lm_head" not in got
    assert_trees_bitwise(got, _ref_tree(want))
    plain, _ = weights.load_checkpoint(d, device="cpu")
    assert "lm_head" not in plain


# -- refusals -------------------------------------------------------------------

def test_missing_tensor_raises_key_error(tmp_path):
    cfg = tiny_cfg()
    tensors = random_hf_tensors(cfg)
    del tensors["model.layers.1.mlp.up_proj.weight"]
    d = write_hf_dir(tmp_path, tensors, cfg)
    with pytest.raises(KeyError, match="missing 1 expected"):
        weights.load_checkpoint_quantized(d, device="cpu")
    with pytest.raises(KeyError, match="missing 1 expected"):
        weights.load_checkpoint(d, device="cpu")


def test_directory_without_shards_raises_file_not_found(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf_config_json(tiny_cfg()), f)
    for load in (weights.load_checkpoint, weights.load_checkpoint_quantized):
        with pytest.raises(FileNotFoundError, match="no .safetensors"):
            load(str(tmp_path), device="cpu")


def test_supplied_config_identity(ckpt_dirs):
    d = ckpt_dirs[("llama", torch.bfloat16)]
    stored = weights.config_from_hf_json(os.path.join(d, "config.json"))
    supplied = stored.with_(name="my-registry-tag", max_seq_len=1024)
    got, cfg = weights.load_checkpoint_quantized(d, config=supplied,
                                                 device="cpu")
    assert cfg.name == "my-registry-tag" and cfg.max_seq_len == 1024
    with pytest.raises(ValueError, match="identity fields: num_layers"):
        weights.load_checkpoint_quantized(
            d, config=stored.with_(num_layers=3), device="cpu")


def test_unsupported_family_raises_before_reading(ckpt_dirs, monkeypatch):
    import p2p_llm_chat_tpu_torch.models as models
    monkeypatch.setattr(models, "family_for", lambda cfg: object())
    monkeypatch.setattr(weights, "_Shards", None)    # never reached
    with pytest.raises(weights.UnsupportedForQuantizedLoad):
        weights.load_checkpoint_quantized(ckpt_dirs[("llama",
                                                     torch.float32)],
                                          device="cpu")


def test_native_orbax_directory_is_refused(tmp_path):
    (tmp_path / "native_meta.json").write_text('{"config": "tiny"}')
    for load in (weights.load_checkpoint, weights.load_checkpoint_quantized):
        with pytest.raises(SystemExit, match="native Orbax"):
            load(str(tmp_path), device="cpu")
    with pytest.raises(SystemExit, match="native Orbax"):
        weights.load_checkpoint_streaming(str(tmp_path))
