"""Logical-axis sharding rules and this rank's shard, the port of
p2p_llm_chat_tpu/parallel/sharding.py.

Model code names parameter dimensions with logical axes ("embed",
"heads", "mlp", "vocab", "experts", ...); :data:`DEFAULT_RULES` binds
them to mesh axes, and :func:`spec_for` / :func:`tree_specs` turn a
leaf's logical axes into its spec — a tuple of mesh-axis entries (the
port has no ``PartitionSpec``; the tuples equal the reference's).

The Megatron layout of the reference: q/k/v column-split over heads and
``wo`` row-split (one all-reduce over ``tp`` after ``wo``), gate/up
column-split over the FFN width and ``w_down`` row-split (one after
``w_down``), the embedding and lm_head split over the vocabulary, and
expert stacks over ``("ep", "tp")``. :class:`Split` is the one place
that decides, for a config on a rank of a mesh, what is cut: both
:func:`shard_params` (the weights) and the model forms (their
collectives, models/llama.py) read it.

- The port splits by heads, never inside a head: where ``tp`` does not
  divide ``num_heads``, ``num_kv_heads`` or the FFN width, the layers
  stay whole on every rank (models/llama.py's ``fuse_tp_for`` rule;
  the reference's ``constrain`` does the same for activations). The
  reference's ``shard_params`` splits the flat column axis there
  (``tiny``'s ``wk`` at tp = 4: four 16-column shards of two 32-wide kv
  heads), which attention on one rank cannot use; only the layout
  differs, the result is the same. The vocabulary and the expert
  stacks are cut wherever their mesh axes divide them.
- ``constrain`` (the reference's in-jit activation hint) has no
  counterpart: the port's layouts are explicit, each form runs on its
  rank's slices and the collectives are written out.
- Two more layouts serve the reference's pipeline and ring programs
  (parallel/pipeline.py, parallel/ring.py): :func:`stage_layers` keeps a
  pipeline stage's contiguous block of the stacked layers (the
  reference's ``_stage_specs``), and the ring's rules (``RING_RULES``:
  the embedding and lm_head whole) go to :meth:`Split.of` and
  :func:`shard_model` as ``rules``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch

from ..models.configs import ModelConfig
from ..utils.log import get_logger
from .mesh import Mesh

log = get_logger("parallel.sharding")
# Leaf names whose int4 cut fell inside a group, logged once each.
_GROUP_LOGGED: set = set()

# logical axis -> mesh axis (or None = replicated). A logical axis may map to
# a tuple of mesh axes (sharded over their product).
LogicalRules = dict[str, Any]

DEFAULT_RULES: LogicalRules = {
    # weights
    "embed": None,            # hidden dim of residual stream — replicated
    "heads": "tp",            # query heads
    "kv_heads": "tp",         # kv heads (GQA)
    "head_dim": None,
    "mlp": "tp",              # ffn intermediate
    "vocab": "tp",            # embedding/lm_head vocab dim
    "experts": ("ep", "tp"),  # MoE expert dim
    "expert_mlp": None,       # per-expert ffn intermediate (already sharded
                              # over experts; keep dense within an expert)
    # activations
    "batch": "dp",
    "seq": "sp",              # sequence/context parallel shards
    "act_heads": "tp",
    "act_embed": None,
    "act_mlp": "tp",
    "act_vocab": "tp",
    "kv_seq": None,           # kv-cache length axis — replicated under TP
}

# Logical axes the layer split (Split.layers) cuts as one.
_LAYER_AXES = ("heads", "kv_heads", "mlp")


def spec_for(logical_axes: tuple[Optional[str], ...],
             rules: LogicalRules = DEFAULT_RULES) -> tuple:
    """The spec (mesh-axis entry per dim, trailing Nones trimmed) of a
    tensor whose dims carry these logical names."""
    out = []
    for ax in logical_axes:
        if ax is None:
            out.append(None)
        else:
            if ax not in rules:
                raise KeyError(f"unknown logical axis {ax!r}")
            out.append(rules[ax])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_specs(axes_tree: Any, rules: LogicalRules = DEFAULT_RULES) -> Any:
    """Map a tree (dicts) of logical-axis tuples to a tree of specs."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, rules)
    return {k: tree_specs(v, rules) for k, v in axes_tree.items()}


def layer_split(config: ModelConfig, mesh: Optional[Mesh]) -> int:
    """Ways the attention heads and the dense FFN are cut over ``tp``:
    ``tp`` where it divides ``num_heads``, ``num_kv_heads`` and
    ``intermediate_size``, else 1 (whole on every rank) — the
    reference's ``fuse_tp_for``."""
    if mesh is None:
        return 1
    t = mesh.shape.get("tp", 1)
    if t <= 1 or (config.num_heads % t or config.num_kv_heads % t
                  or config.intermediate_size % t):
        return 1
    return t


@dataclass(frozen=True)
class Split:
    """What of a model of ``config`` this rank of ``mesh`` holds, and the
    collectives its forms run. ``layers``: ways the heads, k/v heads and
    dense FFN are cut over ``tp`` (:func:`layer_split`); ``vocab``: ways
    the embedding rows and lm_head columns are cut over ``tp``;
    ``experts``: ways the expert stacks are cut over ``("ep", "tp")``.
    ``config`` is this rank's: local head counts and FFN width."""

    mesh: Mesh
    config: ModelConfig
    layers: int
    vocab: int
    experts: int

    @classmethod
    def of(cls, config: ModelConfig, mesh: Optional[Mesh],
           rules: LogicalRules = DEFAULT_RULES) -> Optional["Split"]:
        """None when nothing is cut (no mesh, one rank, or no axis that
        divides): the single-card forms then run unchanged. ``rules``
        whose "vocab" is None (the ring's) keep the vocabulary whole."""
        if mesh is None or mesh.size == 1:
            return None
        t = mesh.shape.get("tp", 1)
        layers = layer_split(config, mesh)
        vocab = (t if t > 1 and rules.get("vocab") is not None
                 and config.vocab_size % t == 0 else 1)
        ne = mesh.span(DEFAULT_RULES["experts"])
        experts = (ne if config.is_moe and ne > 1
                   and config.num_experts % ne == 0 else 1)
        if layers == vocab == experts == 1:
            return None
        local = config
        if layers > 1:
            local = replace(
                config, num_heads=config.num_heads // layers,
                num_kv_heads=config.num_kv_heads // layers,
                intermediate_size=(config.intermediate_size if config.is_moe
                                   else config.intermediate_size // layers))
        return cls(mesh, local, layers, vocab, experts)

    def ways(self, logical: Optional[str]) -> int:
        """Ways a dimension of this logical axis is cut (1: whole)."""
        if logical in _LAYER_AXES:
            return self.layers
        return {"vocab": self.vocab, "experts": self.experts}.get(logical, 1)

    # -- the forms' collectives (models/llama.py, models/mixtral.py) ------

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Rows of the embedding for ``tokens`` from this rank's vocabulary
        slice: a masked local lookup, summed over ``tp`` (exact: one rank
        holds each row)."""
        if self.vocab == 1:
            return table[tokens]
        n = table.shape[0]
        local = tokens - self.mesh.index("tp") * n
        mine = (local >= 0) & (local < n)
        h = table[local.clamp(0, n - 1)]
        h = torch.where(mine[..., None], h, torch.zeros_like(h))
        return self.mesh.all_reduce(h, "tp")

    def reduce_layer(self, x: torch.Tensor) -> torch.Tensor:
        """The all-reduce after ``wo`` and after ``w_down``."""
        return self.mesh.all_reduce(x, "tp") if self.layers > 1 else x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's logit columns -> every column, in rank order."""
        if self.vocab == 1:
            return logits
        return self.mesh.all_gather(logits, "tp", dim=-1)

    def first_expert(self, local_count: int) -> int:
        return self.mesh.index(DEFAULT_RULES["experts"]) * local_count

    def reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, DEFAULT_RULES["experts"])


def shard_params(params: Any, axes_tree: Any, mesh: Mesh,
                 device: Optional[str | torch.device] = None, *,
                 config: ModelConfig,
                 rules: LogicalRules = DEFAULT_RULES) -> Any:
    """This rank's slice of each leaf of an UNFUSED tree (the reference's
    layout: ``wq``/``wk``/``wv``, ``w_gate``/``w_up``), on ``device``:
    each dim whose logical axis :class:`Split` cuts keeps the block at
    this rank's index along the dim's mesh axes (row-major over a tuple
    entry, as the reference's ``NamedSharding`` places shards); every
    other dim is whole. Plain tensors only (a quantized tree is sharded
    before quantizing). Fuse the result after slicing
    (models/llama.fuse_params), so each rank's ``wqkv`` is
    ``[q_r | k_r | v_r]``."""
    split = Split.of(config, mesh, rules)

    def leaf(x: torch.Tensor, axes: tuple) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"shard_params takes plain tensors, got "
                            f"{type(x).__name__}")
        spec = spec_for(axes, rules)
        for dim, entry in enumerate(spec):
            if entry is None or split is None:
                continue
            n = split.ways(axes[dim])
            if n == 1:
                continue
            if n != mesh.span(entry) or x.shape[dim] % n:
                raise ValueError(f"cannot cut dim {dim} ({axes[dim]}) of "
                                 f"{tuple(x.shape)} {n} ways over {entry}")
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(entry) * size, size)
        # A tensor of its own (never a view of the whole leaf), so the
        # caller's full tree can be freed.
        return torch.empty(x.shape, dtype=x.dtype,
                           device=x.device if device is None
                           else device).copy_(x)

    def walk(p, a):
        if isinstance(p, dict):
            return {k: walk(v, a[k]) for k, v in p.items()}
        return leaf(p, a)

    return walk(params, axes_tree)


def shard_model(params: dict, config: ModelConfig, mesh: Optional[Mesh],
                device: Optional[str | torch.device] = None, *,
                rules: LogicalRules = DEFAULT_RULES) -> dict:
    """This rank's FUSED tree of a model of ``config`` from the whole one
    (fused or not). Plain tensors: unfused into views, cut by
    :func:`shard_params`, fused again, the expert stacks left separate
    (the reference fuses them only with no mesh). A quantized tree
    (int8 ``QTensor`` / int4 ``QTensor4`` leaves, quantized WHOLE, as the
    reference quantizes the sharded global arrays) is cut leaf by leaf in
    its fused layout by :func:`cut_leaf`. Where nothing is cut
    (:meth:`Split.of` is None) the tree is only fused. ``rules``: the
    ring's keep the embedding and lm_head whole (parallel/ring.py)."""
    from ..models import family_for
    from ..models.quant import quant_mode
    family = family_for(config)
    split = Split.of(config, mesh, rules)
    if split is None:
        return _to(family.fuse_params(params), device)
    if quant_mode(params):
        fused = family.fuse_params(params)
        out = {k: (cut_leaf(k, v, split, device) if k != "layers" else
                   {n: cut_leaf(n, w, split, device, stacked=True)
                    for n, w in v.items()})
               for k, v in fused.items()}
        return out
    tree = shard_params(family.unfuse_params(params, config),
                        family.param_axes(config), mesh, device,
                        config=config, rules=rules)
    return family.fuse_params(tree, experts=False)


def stage_layers(params: dict, config: ModelConfig, mesh: Mesh,
                 device: Optional[str | torch.device] = None) -> dict:
    """This rank's pipeline stage of a tree (the reference's
    ``_stage_specs``), FUSED (the family's ``fuse_params``): every leaf
    under ``layers`` — plain, ``QTensor`` or ``QTensor4``, whose ``q`` and
    ``s`` both lead with the layer axis — keeps layers
    ``[s L/pp, (s+1) L/pp)`` for the rank's index ``s`` along ``pp``, as
    tensors of their own on ``device``; every other leaf is whole (the
    embedding, final norm and lm_head: stage 0 embeds, the last stage
    projects)."""
    from ..models import family_for
    from ..models.quant import QTensor, QTensor4
    pp = mesh.shape["pp"]
    L = config.num_layers
    if L % pp:
        raise ValueError(f"{L} layers not divisible by pp={pp}")
    n = L // pp
    lo = mesh.index("pp") * n

    def own(x):
        x = x.narrow(0, lo, n)
        return torch.empty(x.shape, dtype=x.dtype,
                           device=x.device if device is None
                           else device).copy_(x)

    def cut(w):
        if isinstance(w, (QTensor, QTensor4)):
            return type(w)(q=own(w.q), s=own(w.s))
        return own(w)

    out = _to({k: v for k, v in params.items() if k != "layers"}, device)
    out["layers"] = {k: cut(v) for k, v in params["layers"].items()}
    return family_for(config).fuse_params(out)


# -- cutting fused leaves ------------------------------------------------------
#
# A fused leaf's cut is a list of (dim, blocks, ways): along ``dim``
# (counted from the end of the per-layer shape) the leaf is the
# concatenation of ``blocks`` (their sizes), and each block is cut
# ``ways`` ways; the rank keeps its piece of every block, concatenated
# in order (``wqkv`` -> ``[q_r | k_r | v_r]``). Column cuts are dim -1,
# row cuts -2, expert cuts -3.


def fused_cuts(name: str, split: Split, shape: tuple) -> list:
    """The cuts of fused leaf ``name`` (per-layer ``shape``, or the
    top-level ``embed`` / ``lm_head``) on this rank's :class:`Split`."""
    cfg, t = split.config, split.layers
    if name == "embed":
        return [(-2, (shape[-2],), split.vocab)]
    if name == "lm_head":
        return [(-1, (shape[-1],), split.vocab)]
    if len(shape) == 3:            # an expert stack [NE, K, O]
        return ([(-3, (shape[-3],), split.experts)]
                if name in ("wgu_e", "w_down") else [])
    if name == "wqkv":
        q = cfg.num_heads * t * cfg.head_dim
        kv = (shape[-1] - q) // 2
        return [(-1, (q, kv, kv), t)]
    if name == "wgu":
        return [(-1, (shape[-1] // 2,) * 2, t)]
    if name in ("wo", "w_down"):
        return [(-2, (shape[-2],), t)]
    return []


def _narrow_blocks(x: torch.Tensor, dim: int, blocks: tuple, ways: int,
                   i: int) -> torch.Tensor:
    parts, at = [], 0
    for b in blocks:
        if b % ways:
            raise ValueError(f"cannot cut a block of {b} {ways} ways")
        n = b // ways
        parts.append(x.narrow(dim, at + i * n, n))
        at += b
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def cut_leaf(name: str, w, split: Optional[Split],
             device: Optional[str | torch.device] = None, *,
             stacked: bool = False):
    """This rank's part of one FUSED leaf ``name`` (a plain tensor, a
    ``QTensor`` or a ``QTensor4``; ``stacked``: with the leading layer
    axis), as a tensor of its own on ``device``:

    - a plain leaf keeps its pieces of :func:`fused_cuts`;
    - int8 ``q`` is cut like its weight, and its per-output scale with it
      under a column or expert cut; under a row cut (``wo``,
      ``w_down``) the scale reduced over every row and stays whole — the
      reference's global scale;
    - int4 is cut by logical rows: the rank's rows are unpacked and
      packed again in the split-half layout of its own contraction, and
      its group scales are cut by whole groups. Where the cut falls
      inside a group (one group spans several ranks' rows) the rank
      keeps the scale of the group its rows lie in (the whole scale when
      there is one group), and the log says so; rows that straddle a
      group boundary cannot be served and raise."""
    from ..models.quant import QTensor, QTensor4, pack4
    from ..ops.quant_mm import unpack4

    def own(x):
        return torch.empty(x.shape, dtype=x.dtype,
                           device=x.device if device is None
                           else device).copy_(x)

    if split is None:
        return w if device is None else _to(w, device)
    shape = tuple(w.q.shape if isinstance(w, QTensor) else w.shape)
    cuts = [c for c in fused_cuts(name, split,
                                  shape[1:] if stacked else shape)
            if c[2] > 1]
    if not cuts:
        return (type(w)(q=own(w.q), s=own(w.s))
                if isinstance(w, (QTensor, QTensor4)) else own(w))

    def index(dim, ways):
        return split.mesh.index(DEFAULT_RULES["experts"] if dim == -3
                                else "tp")

    if not isinstance(w, (QTensor, QTensor4)):
        for dim, blocks, ways in cuts:
            w = _narrow_blocks(w, dim, blocks, ways, index(dim, ways))
        return own(w)
    q, s = w.q, w.s
    for dim, blocks, ways in cuts:
        i = index(dim, ways)
        if dim != -2:
            q = _narrow_blocks(q, dim, blocks, ways, i)
            s = _narrow_blocks(s, dim, blocks, ways, i)
            continue
        if isinstance(w, QTensor):
            q = _narrow_blocks(q, -2, blocks, ways, i)
            continue
        K = 2 * q.shape[-2]
        ng = s.shape[-2]
        q = pack4(_narrow_blocks(unpack4(q), -2, (K,), ways, i))
        if ng % ways == 0:
            s = _narrow_blocks(s, -2, (ng,), ways, i)
        elif ways % ng == 0:
            s = s.narrow(-2, i * ng // ways, 1)
            if name not in _GROUP_LOGGED:
                _GROUP_LOGGED.add(name)
                log.info("%s: the cut falls inside an int4 group (%d rows "
                         "over %d ranks); each rank keeps its group's "
                         "scale%s", name, K // ng, ways // ng,
                         " (the whole scale)" if ng == 1 else "")
        else:
            raise ValueError(f"{name}: {ng} int4 groups cannot be cut "
                             f"{ways} ways (a rank's rows straddle groups)")
    return type(w)(q=own(q), s=own(s))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if device is None:
        return tree
    if isinstance(tree, tuple):             # a QTensor / QTensor4
        return type(tree)(*(t.to(device) for t in tree))
    return tree.to(device)
