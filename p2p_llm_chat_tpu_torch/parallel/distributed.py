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
- :func:`start_local_world` is ``SERVE_TP`` without a coordinator (the
  reference's ``local_mesh`` over one host's chips): this process
  starts ``t - 1`` follower processes (``python -m
  p2p_llm_chat_tpu_torch.serve.tp``) on 127.0.0.1 at a free port and
  joins them as rank 0. Every rank joins with a time limit, and a
  follower dies with the process that started it (:func:`die_with_parent`),
  so a killed leader leaves no rank holding a card.

The reference's ``_enable_cpu_collectives`` switches JAX's CPU client to
gloo; torch.distributed has gloo on the CPU already, so it has no
counterpart.
"""

from __future__ import annotations

import atexit
import ctypes
import datetime
import gc
import os
import signal
import socket
import subprocess
import sys
import time
import weakref
from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.log import get_logger
from .mesh import Mesh, MeshConfig, make_mesh

log = get_logger("parallel.distributed")

# A follower waits on the control group between requests for as long as
# the leader is idle (the compute groups' limit: mesh.COMPUTE_TIMEOUT).
CONTROL_TIMEOUT = datetime.timedelta(days=365)


# The meshes over this world (multihost_mesh), whose group handles
# leave_world drops.
_MESHES: "weakref.WeakSet[Mesh]" = weakref.WeakSet()


def _up() -> bool:
    d = torch.distributed
    return d.is_available() and d.is_initialized()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     join_timeout_s: Optional[float] = None) -> bool:
    """Join the world; True when this process is in one. No-op (False)
    when neither the arguments nor the env name a coordinator or a
    process count. ``join_timeout_s``: the join fails (raises) when the
    world is not whole within it; without it the join may wait as long
    as the control group does."""
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
    if join_timeout_s is None:
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=n,
            rank=pid, timeout=CONTROL_TIMEOUT)
    else:
        host, port = coordinator.rsplit(":", 1)
        store = torch.distributed.TCPStore(
            host, int(port), n, is_master=pid == 0,
            timeout=datetime.timedelta(seconds=join_timeout_s))
        torch.distributed.init_process_group(
            "gloo", store=store, world_size=n, rank=pid,
            timeout=CONTROL_TIMEOUT)
    atexit.register(leave_world)
    log.info("distributed runtime up: process %d/%d (control group gloo "
             "via %s)", pid, n, coordinator)
    return True


def leave_world() -> None:
    """Destroy every process group and drop every mesh's handles to them
    (:func:`multihost_mesh` keeps a weak list). A gloo group still
    referenced when the interpreter exits is torn down during its
    finalization, which can abort the process ("terminate called without
    an active exception") after its work is done; none is left for it
    here. :func:`init_distributed` also runs this at exit."""
    d = torch.distributed
    if d.is_available() and d.is_initialized():
        d.destroy_process_group()
    for mesh in list(_MESHES):
        mesh.groups.clear()
        mesh.control = mesh.world = None
    gc.collect()


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def die_with_parent(parent: int) -> None:
    """Ask Linux to SIGKILL this process when the thread that started it
    exits (``prctl(PR_SET_PDEATHSIG)``; raises where that cannot be
    set), and exit now if ``parent`` (its pid; 0 = unknown) is already
    gone."""
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    if libc.prctl(1, signal.SIGKILL, 0, 0, 0) != 0:     # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if parent and os.getppid() != parent:
        os._exit(1)


def cpu_threads(world: int) -> int:
    """Intra-op threads for each of ``world`` ranks computing on one
    host's CPU cores: ``OMP_NUM_THREADS`` when the environment sets it,
    else this process's cores split evenly (at least one)."""
    env = os.environ.get("OMP_NUM_THREADS", "")
    if env.isdigit() and int(env) > 0:
        return int(env)
    return max(1, len(os.sched_getaffinity(0)) // max(1, world))


def start_local_world(tp: int, join_timeout_s: float = 300.0,
                      cpu: bool = False) -> list[subprocess.Popen]:
    """Start ranks 1 .. ``tp``-1 as follower processes (``python -m
    p2p_llm_chat_tpu_torch.serve.tp``, this process's env plus
    ``SERVE_TP_WORLD`` / ``SERVE_TP_RANK`` / ``SERVE_TP_PARENT`` /
    ``SERVE_TP_JOIN_S``) on 127.0.0.1 at a free port and join them as
    rank 0, every rank within ``join_timeout_s``. Returns the followers'
    processes (killed here if the join fails).

    ``cpu``: the ranks compute on this host's CPU cores, so they share
    them: each rank, this one included, runs :func:`cpu_threads` intra-op
    threads (``OMP_NUM_THREADS`` in the followers' env) instead of
    torch's default of one a core each, which oversubscribes the cores
    ``tp`` times over. What the ranks compute does not change."""
    addr = f"127.0.0.1:{free_port()}"
    extra = {}
    if cpu:
        threads = cpu_threads(tp)
        extra["OMP_NUM_THREADS"] = str(threads)
        torch.set_num_threads(threads)
        log.info("local tensor-parallel world on the CPU: %d intra-op "
                 "threads a rank", threads)
    procs = []
    try:
        for rank in range(1, tp):
            env = dict(os.environ, SERVE_TP=str(tp), SERVE_TP_WORLD=addr,
                       SERVE_TP_RANK=str(rank),
                       SERVE_TP_PARENT=str(os.getpid()),
                       SERVE_TP_JOIN_S=str(join_timeout_s), **extra)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "p2p_llm_chat_tpu_torch.serve.tp"],
                env=env))
        init_distributed(coordinator=addr, num_processes=tp, process_id=0,
                         join_timeout_s=join_timeout_s)
    except BaseException:
        stop_processes(procs, 0.0)
        raise
    log.info("local tensor-parallel world up: %d ranks via %s (followers "
             "%s)", tp, addr, [p.pid for p in procs])
    return procs


def stop_processes(procs: list, timeout_s: float) -> list:
    """Wait up to ``timeout_s`` for ``procs`` to exit, kill the rest;
    their exit codes."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)
    return [p.returncode for p in procs]


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
    mesh = make_mesh(cfg, backend=_logged_backend(world))
    _MESHES.add(mesh)
    return mesh
