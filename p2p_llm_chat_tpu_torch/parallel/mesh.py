"""The mesh of ranks, the port of p2p_llm_chat_tpu/parallel/mesh.py.

The canonical axes are the reference's (``dp`` data parallel, ``pp``
pipeline, ``ep`` expert, ``sp`` sequence, ``tp`` tensor parallel, ``tp``
innermost). In PyTorch one process drives one card, so a mesh lays out
the world's RANKS, not devices: :func:`make_mesh` reshapes them to
``[dp, pp, ep, sp, tp]`` and builds one ``torch.distributed`` process
group for each line of every axis of size > 1 (and for the expert axes
``("ep", "tp")`` together), so each rank holds the groups of its own
lines. A size-1 axis has no group, and a mesh of one rank none at all:
the model code treats it as no mesh.

The :class:`Mesh` is also where the collectives live (:meth:`Mesh.
all_reduce`, :meth:`Mesh.all_gather`, :meth:`Mesh.broadcast`, and the
shift along a ring or a chain, :meth:`Mesh.ppermute`): every one the model
forms, the pipeline and ring programs, the multi-process plane and the
tensor-parallel KV tier run goes through it, so it can time them
(:meth:`Mesh.take_collective_ms`).
"""

from __future__ import annotations

import contextlib
import datetime
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

AXES = ("dp", "pp", "ep", "sp", "tp")
# Axis tuples a logical rule binds to (parallel/sharding.DEFAULT_RULES'
# "experts"): each gets a group of its own over the product of its axes.
_JOINT = (("ep", "tp"),)
# A compute collective sits inside a round: a wait of minutes is a fault.
COMPUTE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.ep * self.sp * self.tp

    @classmethod
    def for_devices(cls, n: int, tp: int | None = None) -> "MeshConfig":
        """Default layout: everything tensor-parallel (the decode-serving
        sweet spot on a single slice — weights sharded, batch replicated)."""
        return cls(tp=n if tp is None else tp,
                   dp=1 if tp is None else n // tp)


@dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh: ``shape`` (axis -> size, as
    ``jax.sharding.Mesh.shape``), its coordinates, and the process
    groups of its lines (``groups``: axis or axis tuple -> group; only
    axes of size > 1). ``backend`` is the compute groups' backend
    (``"gloo"`` or ``"nccl"``, parallel/distributed.compute_backend;
    None without torch.distributed), ``control`` the gloo group the
    leader's commands ride, ``world`` a compute group over every rank of
    the mesh (None without torch.distributed)."""

    shape: dict
    coords: dict
    groups: dict = field(default_factory=dict)
    rank: int = 0
    backend: Optional[str] = None
    control: object = None
    world: object = None
    _timed: list = field(default_factory=list)
    _host_ms: float = 0.0
    # Bytes this rank has sent by :meth:`ppermute` (never reset here).
    sent_bytes: int = 0

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    @classmethod
    def at(cls, cfg: MeshConfig, rank: int) -> "Mesh":
        """The coordinates of ``rank`` in a mesh of ``cfg`` with no
        process group: what parallel/sharding.shard_params needs to cut
        that rank's shard, with no world to join."""
        return cls(shape=_shape(cfg), coords=_coords(cfg, rank), rank=rank)

    def span(self, axes) -> int:
        """The product of the sizes of ``axes`` (an axis or a tuple)."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over a tuple, as a
        ``PartitionSpec`` entry of several axes counts)."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The group of this rank's line along ``axes``, or None where the
        line is this rank alone."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        big = tuple(a for a in axes if self.shape[a] > 1)
        if not big:
            return None
        return self.groups[big[0] if len(big) == 1 else big]

    # -- collectives ------------------------------------------------------

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``x`` over the line
        along ``axes``, in place; ``x`` itself where the line is this
        rank alone."""
        g = self.group(axes)
        if g is None:
            return x
        red = {"sum": torch.distributed.ReduceOp.SUM,
               "max": torch.distributed.ReduceOp.MAX}[op]
        with self._timing(x):
            torch.distributed.all_reduce(x, op=red, group=g)
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The line's ``x`` concatenated along ``dim`` in rank order."""
        g = self.group(axes)
        if g is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.span(axes))]
        with self._timing(x):
            torch.distributed.all_gather(parts, x, group=g)
        return torch.cat(parts, dim=dim)

    def broadcast(self, x: torch.Tensor, axes, src: int = 0
                  ) -> torch.Tensor:
        """``x`` of the line's rank at index ``src`` along ``axes`` on every
        rank of the line, in place (``x`` contiguous); ``x`` itself where
        the line is this rank alone."""
        g = self.group(axes)
        if g is None:
            return x
        with self._timing(x):
            torch.distributed.broadcast(
                x, torch.distributed.get_global_rank(g, src), group=g)
        return x

    def ppermute(self, x: torch.Tensor, axes, shift: int = 1, *,
                 wrap: bool = True, send: bool = True, recv: bool = True
                 ) -> Optional[torch.Tensor]:
        """The counterpart of ``jax.lax.ppermute`` along ``axes``: this
        rank (index i of n on the line) sends ``x`` to index ``i + shift``
        and returns what index ``i - shift`` sent, a tensor shaped and
        typed like ``x`` on its device.

        ``wrap`` (a ring) takes the indices modulo n. Without it (a
        chain: the pipeline's stages) a rank whose destination lies past
        the line sends nothing, and one whose source lies before it
        receives nothing and returns None. ``send`` / ``recv`` False:
        this rank sits out that half of the exchange this time; the
        callers' schedule, which every rank knows, pairs each send with
        its receive (a rank that only receives passes a tensor of the
        shape and type it expects). Where the line is this rank alone:
        ``x`` under ``wrap``, else None.

        The receive and the send are posted together and then waited on
        (two blocking sends facing each other, as at n = 2, would
        deadlock), each wait bounded by the group's limit. Gloo's
        point-to-point takes host tensors only: there a CUDA tensor goes
        through pinned host memory, copied out before the send and back
        after the receive."""
        dist = torch.distributed
        g = self.group(axes)
        if g is None:
            return x if wrap and send and recv else None
        n, i = self.span(axes), self.index(axes)
        dst, src = i + shift, i - shift
        if wrap:
            dst, src = dst % n, src % n
        send = send and 0 <= dst < n
        recv = recv and 0 <= src < n
        if not (send or recv):
            return None
        staged = x.is_cuda and self.backend != "nccl"
        with self._timing(x):
            ops, buf = [], None
            if recv:
                buf = torch.empty(x.shape, dtype=x.dtype,
                                  device="cpu" if staged else x.device,
                                  pin_memory=staged)
                ops.append(dist.P2POp(dist.irecv, buf,
                                      dist.get_global_rank(g, src), g))
            if send:
                out = x.contiguous()
                if staged:
                    host = torch.empty(x.shape, dtype=x.dtype,
                                       pin_memory=True)
                    out = host.copy_(out)
                ops.append(dist.P2POp(dist.isend, out,
                                      dist.get_global_rank(g, dst), g))
                self.sent_bytes += x.numel() * x.element_size()
            for work in dist.batch_isend_irecv(ops):
                work.wait(COMPUTE_TIMEOUT)
            if staged and buf is not None:
                buf = buf.to(x.device, non_blocking=True)
        return buf

    def drop_collective_timing(self) -> None:
        """Forget the collectives timed since the last take (their events
        need not have completed)."""
        self._timed.clear()
        self._host_ms = 0.0

    def take_collective_ms(self) -> float:
        """The time the collectives took since the last call: CUDA events
        around each on the card (read after the caller's synchronising
        readback), the host clock on the CPU."""
        ms = self._host_ms + sum(a.elapsed_time(b) for a, b in self._timed)
        self._timed.clear()
        self._host_ms = 0.0
        return ms

    @contextlib.contextmanager
    def _timing(self, x: torch.Tensor):
        if x.is_cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self._timed.append((a, b))
        else:
            t = time.perf_counter()
            yield
            self._host_ms += (time.perf_counter() - t) * 1e3


def _shape(cfg: MeshConfig) -> dict:
    return {a: getattr(cfg, a) for a in AXES}


def _coords(cfg: MeshConfig, rank: int) -> dict:
    if not 0 <= rank < cfg.size:
        raise ValueError(f"rank {rank} is outside a mesh of {cfg.size}")
    idx = np.unravel_index(rank, tuple(getattr(cfg, a) for a in AXES))
    return {a: int(i) for a, i in zip(AXES, idx)}


def make_mesh(cfg: MeshConfig, ranks: Optional[Sequence[int]] = None, *,
              backend: Optional[str] = None) -> Mesh:
    """This rank's :class:`Mesh` of ``cfg`` over ``ranks`` (default: the
    first ``cfg.size`` ranks of the world), laid out ``[dp, pp, ep, sp,
    tp]`` with ``tp`` innermost, as the reference lays out devices: the
    tensor-parallel collectives, the per-layer latency-critical ones, run
    between neighbouring ranks, which one host fills first.

    With torch.distributed up, every rank of the world must call this in
    the same order (``new_group`` is collective), members or not; the
    groups take ``backend`` (default: parallel/distributed.
    compute_backend's choice for this world). Without it the mesh must be
    of one rank."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    me = dist.get_rank() if up else 0
    ranks = list(range(cfg.size)) if ranks is None else [int(r)
                                                        for r in ranks]
    if len(ranks) != cfg.size or cfg.size > world:
        raise ValueError(f"mesh needs {cfg.size} ranks, have "
                         f"{min(len(ranks), world)}")
    grid = np.array(ranks).reshape(tuple(getattr(cfg, a) for a in AXES))
    mine = me in ranks
    mesh = Mesh(shape=_shape(cfg),
                coords=_coords(cfg, ranks.index(me)) if mine else {},
                rank=me)
    if not up:
        return mesh
    if backend is None:
        from .distributed import compute_backend
        backend = compute_backend()
    mesh.backend = backend
    mesh.control = dist.group.WORLD

    def lines(axes: tuple) -> np.ndarray:
        pos = [AXES.index(a) for a in axes]
        rest = [i for i in range(len(AXES)) if i not in pos]
        n = int(np.prod([grid.shape[i] for i in pos]))
        return np.transpose(grid, rest + pos).reshape(-1, n)

    # Every rank creates every group, in one order, members or not.
    for axes in [(a,) for a in AXES] + list(_JOINT):
        if any(getattr(cfg, a) == 1 for a in axes):
            continue
        key = axes[0] if len(axes) == 1 else axes
        for line in lines(axes):
            g = dist.new_group(line.tolist(), backend=backend,
                               timeout=COMPUTE_TIMEOUT)
            if me in line:
                mesh.groups[key] = g
    mesh.world = dist.new_group(ranks, backend=backend,
                                timeout=COMPUTE_TIMEOUT)
    return mesh
