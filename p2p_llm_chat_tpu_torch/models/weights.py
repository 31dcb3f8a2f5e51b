"""Checkpoint loading: HF-layout safetensors directories -> the port's
stacked param trees — the port of p2p_llm_chat_tpu/models/weights.py.

A directory holds ``config.json`` and one or more ``*.safetensors``
shards (with or without ``model.safetensors.index.json``; the shards are
walked in sorted order, as the reference does). The shards are read by
the port's own reader (models/safetensors_io.py): zero-copy views of
memory-mapped files, so nothing of ``safetensors`` or ``ml_dtypes`` is
needed.

Transforms against the HF torch layout, as in the reference:
- ``nn.Linear`` stores ``[out, in]``; the port stores ``[in, out]``, so
  every projection is transposed — here on the device, after the upload;
- per-layer tensors stack along a leading ``num_layers`` axis (and
  expert tensors along an expert axis after it).

:func:`load_checkpoint` gives the bf16 (or ``dtype``) tree the
reference's does, unfused. :func:`load_checkpoint_quantized` streams one
layer at a time onto the device straight into the FUSED int8 / int4 tree
(``wqkv`` = q|k|v, ``wgu`` = gate|up, MoE ``wgu_e`` / ``w_down``), the
bf16 tree never existing on the device: each layer's tensors are
uploaded, transposed and concatenated there, rounded to bf16 and
quantized by :func:`models.quant.quantize` / :func:`~.quant.quantize4`,
then written in place into :func:`~.quant.stream_bufs`. The result is
bit-identical to the reference's (host-numpy IEEE f32 abs-max / 127 or
/ 7, round-half-even, clip), which equals load-bf16 -> quantize -> fuse.

Native Orbax directories (reference ``models/checkpoint.py``) need JAX
and Orbax: the port refuses them by name, as it refuses mesh-streaming
loads (:func:`load_checkpoint_streaming`), which wait for parallelism.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator, Optional

import torch

from ..utils.device import resolve_device
from ..utils.log import get_logger
from .configs import ModelConfig, RopeScaling
from .quant import (QTensor, QTensor4, _quantize_leaf, quant_mode,
                    stream_bufs)
from .safetensors_io import SafetensorsFile

log = get_logger("weights")

# The reference's native checkpoint marker (models/checkpoint.py _META).
_NATIVE_META = "native_meta.json"


# -- HF name mapping ----------------------------------------------------------

def _dense_layer_map(i: int) -> dict[str, tuple[str, bool]]:
    """our layer key -> (HF tensor name, transpose?)."""
    p = f"model.layers.{i}"
    return {
        "attn_norm": (f"{p}.input_layernorm.weight", False),
        "wq": (f"{p}.self_attn.q_proj.weight", True),
        "wk": (f"{p}.self_attn.k_proj.weight", True),
        "wv": (f"{p}.self_attn.v_proj.weight", True),
        "wo": (f"{p}.self_attn.o_proj.weight", True),
        "mlp_norm": (f"{p}.post_attention_layernorm.weight", False),
        "w_gate": (f"{p}.mlp.gate_proj.weight", True),
        "w_up": (f"{p}.mlp.up_proj.weight", True),
        "w_down": (f"{p}.mlp.down_proj.weight", True),
    }


def _moe_layer_map(i: int, num_experts: int) -> dict[str, Any]:
    """Mixtral layout: experts w1 (gate), w3 (up), w2 (down) + router gate."""
    p = f"model.layers.{i}"
    return {
        "attn_norm": (f"{p}.input_layernorm.weight", False),
        "wq": (f"{p}.self_attn.q_proj.weight", True),
        "wk": (f"{p}.self_attn.k_proj.weight", True),
        "wv": (f"{p}.self_attn.v_proj.weight", True),
        "wo": (f"{p}.self_attn.o_proj.weight", True),
        "mlp_norm": (f"{p}.post_attention_layernorm.weight", False),
        "router": (f"{p}.block_sparse_moe.gate.weight", True),
        "w_gate": [(f"{p}.block_sparse_moe.experts.{e}.w1.weight", True)
                   for e in range(num_experts)],
        "w_up": [(f"{p}.block_sparse_moe.experts.{e}.w3.weight", True)
                 for e in range(num_experts)],
        "w_down": [(f"{p}.block_sparse_moe.experts.{e}.w2.weight", True)
                   for e in range(num_experts)],
    }


def _layer_map(config: ModelConfig, i: int) -> dict[str, Any]:
    return (_moe_layer_map(i, config.num_experts) if config.is_moe
            else _dense_layer_map(i))


def _as_tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.from_numpy(t)


def convert_hf_state_dict(state: dict, config: ModelConfig,
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """A flat HF state dict (numpy arrays or CPU tensors) as the stacked
    tree, on the CPU. The test oracle; :func:`load_checkpoint` is the
    production path over safetensors files."""
    def get(name: str, transpose: bool) -> torch.Tensor:
        t = _as_tensor(state[name])
        return t.T.contiguous() if transpose else t

    L = config.num_layers
    maps = [_layer_map(config, i) for i in range(L)]
    layers: dict[str, Any] = {}
    for key in maps[0]:
        per_layer = []
        for i in range(L):
            spec = maps[i][key]
            if isinstance(spec, list):   # per-expert stack
                per_layer.append(torch.stack([get(n, t) for n, t in spec]))
            else:
                per_layer.append(get(*spec))
        layers[key] = torch.stack(per_layer).to(dtype)
    params: dict[str, Any] = {
        "embed": _as_tensor(state["model.embed_tokens.weight"]).to(dtype),
        "layers": layers,
        "final_norm": _as_tensor(state["model.norm.weight"]).to(dtype),
    }
    if not config.tie_embeddings:
        params["lm_head"] = get("lm_head.weight", True).to(dtype)
    return params


# -- config.json --------------------------------------------------------------

def config_from_hf_json(path: str) -> ModelConfig:
    """Derive a ModelConfig from an HF config.json (llama/mixtral families)."""
    with open(path) as f:
        hf = json.load(f)
    rope_scaling = None
    rs = hf.get("rope_scaling")
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        rope_scaling = RopeScaling(
            factor=float(rs.get("factor", 8.0)),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            original_max_position=int(
                rs.get("original_max_position_embeddings", 8192)),
        )
    num_heads = int(hf["num_attention_heads"])
    eos = hf.get("eos_token_id", 2)
    eos_ids = tuple(eos) if isinstance(eos, list) else (int(eos),)
    return ModelConfig(
        name=hf.get("_name_or_path", "hf-model"),
        vocab_size=int(hf["vocab_size"]),
        hidden_size=int(hf["hidden_size"]),
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=num_heads,
        num_kv_heads=int(hf.get("num_key_value_heads", num_heads)),
        # Mixtral configs carry an explicit ``"head_dim": null``.
        head_dim=int(hf.get("head_dim") or hf["hidden_size"] // num_heads),
        max_seq_len=int(hf.get("max_position_embeddings", 8192)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        num_experts=int(hf.get("num_local_experts", 0)),
        num_experts_per_tok=int(hf.get("num_experts_per_tok", 0)),
        bos_token_id=int(hf.get("bos_token_id", 1)),
        eos_token_ids=eos_ids,
    )


def _reverse_name_map(config: ModelConfig) -> dict[str, tuple]:
    """HF tensor name -> (leaf key path, layer index or None, expert index
    or None, transpose?) for every per-layer tensor, plus the top-level
    names. Derived from the same forward maps as the oracle, so the
    loaders cannot drift from it."""
    out: dict[str, tuple] = {
        "model.embed_tokens.weight": (("embed",), None, None, False),
        "model.norm.weight": (("final_norm",), None, None, False),
    }
    if not config.tie_embeddings:
        out["lm_head.weight"] = (("lm_head",), None, None, True)
    for i in range(config.num_layers):
        for key, spec in _layer_map(config, i).items():
            if isinstance(spec, list):
                for e, (name, tr) in enumerate(spec):
                    out[name] = (("layers", key), i, e, tr)
            else:
                name, tr = spec
                out[name] = (("layers", key), i, None, tr)
    return out


# -- the shards ---------------------------------------------------------------

def is_native_checkpoint(ckpt_dir: str) -> bool:
    """A native Orbax directory of the reference (its metadata file)."""
    return os.path.exists(os.path.join(ckpt_dir, _NATIVE_META))


def _refuse_native(ckpt_dir: str) -> None:
    if is_native_checkpoint(ckpt_dir):
        raise SystemExit(
            f"{ckpt_dir} is a native Orbax checkpoint (reference "
            "models/checkpoint.py, which needs JAX and Orbax): the PyTorch "
            "port reads HF safetensors directories only; convert it, or "
            "serve it from the JAX package")


def _shard_paths(ckpt_dir: str) -> list[str]:
    shards = sorted(f for f in os.listdir(ckpt_dir)
                    if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {ckpt_dir}")
    return [os.path.join(ckpt_dir, s) for s in shards]


def _missing_error(ckpt_dir: str, missing) -> KeyError:
    return KeyError(
        f"checkpoint {ckpt_dir} is missing {len(missing)} expected "
        f"tensor(s), e.g. {sorted(missing)[:3]} — truncated download or "
        "wrong config?")


def _iter_hf_tensors(ckpt_dir: str, config: ModelConfig
                     ) -> Iterator[tuple[tuple, Optional[int], Optional[int],
                                         torch.Tensor]]:
    """Yield ``(leaf_path, layer, expert, tensor)`` for every mapped
    tensor across the dir's shards, in sorted shard order and file order,
    the transpose applied as a view (:func:`_upload` moves it to the
    device without a host copy). Raises FileNotFoundError with no shards;
    KeyError when mapped tensors are absent (zeros where weights should
    be would be garbage logits with no error)."""
    name_map = _reverse_name_map(config)
    missing = set(name_map)
    for path in _shard_paths(ckpt_dir):
        f = SafetensorsFile(path)
        for name in f.keys():
            entry = name_map.get(name)
            if entry is None:
                continue
            leaf, layer, expert, transpose = entry
            t = f.get(name)
            missing.discard(name)
            yield leaf, layer, expert, (t.T if transpose else t)
        log.info("streamed shard %s (%d/%d tensors placed)",
                 os.path.basename(path), len(name_map) - len(missing),
                 len(name_map))
    if missing:
        raise _missing_error(ckpt_dir, missing)


class _Shards:
    """Every shard of a directory, mapped, with the tensor names indexed
    (headers only: no tensor bytes are read here). Raises as
    :func:`_iter_hf_tensors` does, before any upload."""

    def __init__(self, ckpt_dir: str, config: ModelConfig) -> None:
        self._where: dict[str, SafetensorsFile] = {}
        for path in _shard_paths(ckpt_dir):
            f = SafetensorsFile(path)
            for name in f.keys():
                self._where.setdefault(name, f)
        missing = set(_reverse_name_map(config)) - set(self._where)
        if missing:
            raise _missing_error(ckpt_dir, missing)

    def get(self, spec: tuple[str, bool]) -> torch.Tensor:
        name, transpose = spec
        t = self._where[name].get(name)
        return t.T if transpose else t


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, contiguous: a transposed view of a contiguous
    tensor moves as the contiguous bytes and is transposed there."""
    if t.ndim == 2 and not t.is_contiguous() and t.T.is_contiguous():
        return t.T.to(device).T.contiguous()
    return t.to(device)


# -- loaders ------------------------------------------------------------------

def load_checkpoint(ckpt_dir: str, config: Optional[ModelConfig] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device | str] = None
                    ) -> tuple[dict, ModelConfig]:
    """The unfused ``dtype`` tree of an HF directory on ``device`` (the
    card unless the CPU is asked for), as the reference's
    ``load_checkpoint`` builds it (one card, no mesh). Each tensor is
    uploaded from its mapping and written into its (layer[, expert])
    slot of a stacked leaf allocated on the device, so the host holds no
    copy of the checkpoint."""
    _refuse_native(ckpt_dir)
    if config is None:
        config = config_from_hf_json(os.path.join(ckpt_dir, "config.json"))
    device = resolve_device(device)
    L, NE = config.num_layers, config.num_experts
    params: dict[str, Any] = {"layers": {}}
    for path, layer, expert, t in _iter_hf_tensors(ckpt_dir, config):
        d = _upload(t, device)
        if layer is None:
            params[path[-1]] = d.to(dtype)
            continue
        key = path[-1]
        leaf = params["layers"].get(key)
        if leaf is None:
            lead = (L,) if expert is None else (L, NE)
            leaf = params["layers"][key] = torch.empty(
                (*lead, *d.shape), dtype=dtype, device=device)
        (leaf[layer] if expert is None else leaf[layer, expert]).copy_(d)
    params = {"embed": params["embed"], "layers": params["layers"],
              "final_norm": params["final_norm"],
              **({"lm_head": params["lm_head"]} if "lm_head" in params
                 else {})}
    log.info("loaded %s: %.2fB params (%s)", config.name,
             _n_logical(params) / 1e9, dtype)
    return params, config


def _n_logical(tree) -> int:
    """Logical weights of a tree (a packed int4 byte holds two)."""
    if isinstance(tree, dict):
        return sum(_n_logical(v) for v in tree.values())
    if isinstance(tree, QTensor4):
        return 2 * tree.q.numel()
    if isinstance(tree, QTensor):
        return tree.q.numel()
    return tree.numel()


def load_checkpoint_streaming(*args, **kwargs):
    """The reference's mesh-sharded streaming load: not in the port until
    it serves across cards (tensor parallelism)."""
    raise SystemExit("load_checkpoint_streaming (mesh-sharded checkpoint "
                     "loads) is not ported to the PyTorch engine yet: it "
                     "waits for parallelism; one card loads through "
                     "load_checkpoint or load_checkpoint_quantized")


class UnsupportedForQuantizedLoad(ValueError):
    """The checkpoint's family is outside load_checkpoint_quantized's
    scope — callers fall back to the standard paths. A dedicated type so
    fallbacks cannot swallow real load errors (corrupt shards etc.),
    which must propagate."""


# Fields that decide whether a caller-supplied config names the SAME
# MODEL as a checkpoint: every tensor-shape-bearing field. Runtime knobs
# (max_seq_len, rope, eps, token ids, capacity factor) may differ.
_CONFIG_IDENTITY_FIELDS = (
    "vocab_size", "hidden_size", "intermediate_size", "num_layers",
    "num_heads", "num_kv_heads", "head_dim", "tie_embeddings",
    "num_experts", "num_experts_per_tok",
)


def _check_config_identity(supplied: ModelConfig, stored: ModelConfig,
                           ckpt_dir: str, check_name: bool = True) -> None:
    """Raise unless ``supplied`` names the same model as the checkpoint's
    own ``stored`` config, on the identity fields only; on agreement the
    supplied config wins. HF directories derive ``name`` from
    ``_name_or_path``, which never equals a registry name, so the HF
    branch passes ``check_name=False``."""
    fields = _CONFIG_IDENTITY_FIELDS + (("name",) if check_name else ())
    bad = [f for f in fields if getattr(supplied, f) != getattr(stored, f)]
    if bad:
        raise ValueError(
            f"config mismatch: caller passed {supplied.name!r} but the "
            f"checkpoint at {ckpt_dir} carries {stored.name!r} "
            f"(differing identity fields: {', '.join(bad)})")


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def load_checkpoint_quantized(ckpt_dir: str,
                              config: Optional[ModelConfig] = None,
                              quant: str = "int8",
                              device: Optional[torch.device | str] = None,
                              stats: Optional[dict] = None,
                              ) -> tuple[dict, ModelConfig]:
    """Stream an HF directory onto ``device`` (the card unless the CPU is
    asked for) straight into the FUSED quantized tree: ``quant`` ``int8``
    (per-channel) or ``int4`` (group-wise; a leaf whose contraction cannot
    group keeps int8, as in the reference).

    Per layer: the layer's tensors are read from their mappings and
    uploaded, transposed and concatenated on the device into
    ``fuse_params``' layout (``wqkv`` = q|k|v, ``wgu`` = gate|up; MoE
    ``wgu_e`` [NE, H, 2F] and ``w_down`` [NE, F, H], one expert at a
    time), rounded to bf16 (the serving dtype the reference quantizes),
    quantized and written in place into the stacked buffers. The norms
    and the router stay bf16; the lm_head is quantized with the same
    per-leaf choice; a tied config has no ``lm_head`` leaf. The result is
    bit-identical to load-at-bf16 -> quantize -> fuse.

    ``stats``, when given, receives the walls: ``layers_s`` (per layer:
    read + upload s, quantize s), ``top_s`` and ``total_s`` (the card
    synchronised at each boundary)."""
    from . import family_for, llama, mixtral

    if quant not in ("int8", "int4"):
        raise ValueError(f"quant must be int8|int4, got {quant!r}")
    _refuse_native(ckpt_dir)
    # The family gate first, from metadata alone: a rejected checkpoint
    # is not read before the caller re-loads it another way.
    stored = config_from_hf_json(os.path.join(ckpt_dir, "config.json"))
    if config is None:
        config = stored
    else:
        _check_config_identity(config, stored, ckpt_dir, check_name=False)
    if family_for(config) not in (llama, mixtral):
        raise UnsupportedForQuantizedLoad(
            "load_checkpoint_quantized covers the llama and mixtral "
            f"families; {config.name} keeps the standard load paths")
    device = resolve_device(device)
    shards = _Shards(ckpt_dir, config)
    bf16 = torch.bfloat16
    moe = config.is_moe
    L, H = config.num_layers, config.hidden_size
    F, NE = config.intermediate_size, config.num_experts
    dims: dict[str, tuple] = {
        "wqkv": (H, config.q_dim + 2 * config.kv_dim),
        "wo": (config.q_dim, H),
    }
    if moe:
        dims.update(wgu_e=(NE, H, 2 * F), w_down=(NE, F, H))
    else:
        dims.update(wgu=(H, 2 * F), w_down=(F, H))
    bufs = {name: stream_bufs(L, shape, quant, device)
            for name, shape in dims.items()}
    layers: dict[str, Any] = {
        "attn_norm": torch.empty((L, H), dtype=bf16, device=device),
        "mlp_norm": torch.empty((L, H), dtype=bf16, device=device),
    }
    if moe:
        layers["router"] = torch.empty((L, H, NE), dtype=bf16, device=device)

    def put(name: str, idx: tuple, w: torch.Tensor) -> None:
        # Round through bf16 (f32 shards included), then quantize with
        # the stacked buffer's own precision choice.
        qt = _quantize_leaf(w.to(bf16), quant, expert=len(idx) == 2)
        bufs[name].q[idx] = qt.q
        bufs[name].s[idx] = qt.s

    def up(spec) -> torch.Tensor:
        return _upload(shards.get(spec), device)

    per_layer = []
    t_start = t0 = _sync(device)
    for li in range(L):
        m = _layer_map(config, li)
        layers["attn_norm"][li] = up(m["attn_norm"])
        layers["mlp_norm"][li] = up(m["mlp_norm"])
        wqkv = torch.cat([up(m["wq"]), up(m["wk"]), up(m["wv"])], dim=1)
        wo = up(m["wo"])
        read_s, quant_s = 0.0, 0.0
        t1 = _sync(device)
        read_s += t1 - t0
        put("wqkv", (li,), wqkv)
        put("wo", (li,), wo)
        del wqkv, wo
        t0 = _sync(device)
        quant_s += t0 - t1
        if moe:
            layers["router"][li] = up(m["router"])
            experts = zip(m["w_gate"], m["w_up"], m["w_down"])
        else:
            experts = [(m["w_gate"], m["w_up"], m["w_down"])]
        for e, (g, u, d) in enumerate(experts):
            wgu = torch.cat([up(g), up(u)], dim=1)
            wd = up(d)
            t1 = _sync(device)
            read_s += t1 - t0
            idx = (li, e) if moe else (li,)
            put("wgu_e" if moe else "wgu", idx, wgu)
            put("w_down", idx, wd)
            del wgu, wd
            t0 = _sync(device)
            quant_s += t0 - t1
        per_layer.append((read_s, quant_s))
    layers.update(bufs)
    params: dict[str, Any] = {
        "embed": up(("model.embed_tokens.weight", False)).to(bf16),
        "layers": layers,
        "final_norm": up(("model.norm.weight", False)).to(bf16),
    }
    if not config.tie_embeddings:
        head = up(("lm_head.weight", True)).to(bf16)
        params["lm_head"] = _quantize_leaf(head, quant)
        del head
    t_end = _sync(device)
    if stats is not None:
        stats.update(layers_s=per_layer, top_s=t_end - t0,
                     total_s=t_end - t_start)
    log.info("loaded %s quantized+fused (streaming, one layer at a time "
             "on %s) in %.1f s: %.2fB params %s", config.name, device,
             t_end - t_start, _n_logical(params) / 1e9,
             quant_mode(params) or "int8")
    return params, config
