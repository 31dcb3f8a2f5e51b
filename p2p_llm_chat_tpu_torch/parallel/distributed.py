"""Joining a world of processes, the port of
p2p_llm_chat_tpu/parallel/distributed.py on ``torch.distributed``.

One process drives one card (``cuda:(rank % device_count)``), or the CPU
when the caller asks for it (``SERVE_DEVICE=cpu``, ``device="cpu"``).

- :func:`init_distributed` joins the world from the reference's env
  (``SERVE_COORDINATOR`` or ``JAX_COORDINATOR`` = host:port of process
  0, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); with none of them set it
  is a no-op that returns False. The world's default group is gloo: the
  CONTROL group, which carries the leader's int32 commands
  (serve/multihost.py) on the host.
- :func:`compute_backend` picks the backend of the groups that carry
  tensors: NCCL when no two ranks share a card, which the ranks learn by
  all-gathering (host, card) over the control group; otherwise, and
  always on the CPU, gloo (NCCL refuses two ranks on one device; gloo
  stages CUDA tensors through the host). A rule, not a setting; the
  choice is logged and kept on the mesh (``Mesh.backend``).
- :func:`multihost_mesh` keeps the reference's checks: the mesh covers
  the world, and ``dp`` is a multiple of the host count, so a replica
  never straddles a host (in the port a process holds one card, so the
  host takes the place of the reference's multi-device process).

The reference's ``_enable_cpu_collectives`` switches JAX's CPU client to
gloo; torch.distributed has gloo on the CPU already, so it has no
counterpart.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.log import get_logger
from .mesh import Mesh, MeshConfig, make_mesh

log = get_logger("parallel.distributed")

# A follower waits on the control group between requests for as long as
# the leader is idle (the compute groups' limit: mesh.COMPUTE_TIMEOUT).
CONTROL_TIMEOUT = datetime.timedelta(days=365)


def _up() -> bool:
    d = torch.distributed
    return d.is_available() and d.is_initialized()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the world; True when this process is in one. No-op (False)
    when neither the arguments nor the env name a coordinator or a
    process count."""
    coordinator = (coordinator or os.environ.get("SERVE_COORDINATOR")
                   or os.environ.get("JAX_COORDINATOR"))
    n = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "-1") or -1)
    if not coordinator and n == 0:
        return False
    if _up():
        return True
    if not coordinator or n <= 0 or not 0 <= pid < n:
        raise ValueError(
            "a world needs a coordinator address (SERVE_COORDINATOR or "
            "JAX_COORDINATOR, host:port of process 0), JAX_NUM_PROCESSES "
            f"and JAX_PROCESS_ID in [0, n); got {coordinator!r}, n={n}, "
            f"id={pid}")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=n, rank=pid,
        timeout=CONTROL_TIMEOUT)
    log.info("distributed runtime up: process %d/%d (control group gloo "
             "via %s)", pid, n, coordinator)
    return True


def rank_device(device: Optional[str | torch.device] = None
                ) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` unless the
    caller or ``SERVE_DEVICE`` names one (see utils/device.py; no card
    and no request for the CPU raises)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = torch.distributed.get_rank() if _up() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def peers(device: Optional[str | torch.device] = None) -> list:
    """(host, device) of every rank, in rank order, all-gathered over the
    control group (collective: every rank calls it)."""
    me = (socket.gethostname(), str(rank_device(device)))
    if not _up():
        return [me]
    out: list = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, me)
    return out


def choose_backend(world: list) -> str:
    """The compute backend for ranks at ``world`` [(host, device), ...]:
    NCCL when every rank has a card of its own, else gloo."""
    cards = [w for w in world if w[1].startswith("cuda")]
    if len(cards) == len(world) and len(set(world)) == len(world):
        return "nccl"
    return "gloo"


def compute_backend(device: Optional[str | torch.device] = None) -> str:
    """:func:`choose_backend` for this world (collective), logged."""
    return _logged_backend(peers(device))


def _logged_backend(world: list) -> str:
    backend = choose_backend(world)
    shared = len(world) - len(set(world))
    log.info("compute groups on %s: %d ranks on %d distinct devices%s",
             backend, len(world), len(set(world)),
             f" ({shared} share a device)" if shared else "")
    return backend


def check_layout(cfg: MeshConfig, world: int, hosts: int) -> None:
    """The reference's checks of a world's mesh: it covers the world,
    and ``dp`` is a multiple of the host count."""
    if cfg.size != world:
        raise ValueError(f"mesh size {cfg.size} != world size {world}")
    if cfg.dp % hosts:
        raise ValueError(
            f"dp={cfg.dp} must be a multiple of host count {hosts} (a "
            "replica cannot straddle a host boundary)")


def multihost_mesh(cfg: MeshConfig,
                   device: Optional[str | torch.device] = None) -> Mesh:
    """This rank's mesh of ``cfg`` over the world, after
    :func:`check_layout` (collective); with no world,
    :func:`~.mesh.make_mesh`."""
    if not _up():
        return make_mesh(cfg)
    world = peers(device)
    if len(world) > 1:
        check_layout(cfg, len(world), len({h for h, _ in world}))
    return make_mesh(cfg, backend=_logged_backend(world))
