"""``SERVE_TP`` inside the continuous-batching engine: the leader's device
ops as one ordered stream to the follower ranks.

The reference serves ``SERVE_TP = t`` from one process: its scheduler's
jitted programs take mesh-sharded operands and XLA's SPMD partitioner
places every collective, so it has no counterpart to this module. In
PyTorch one process drives one card, so the port takes the leader-worker
shape: rank 0 runs the front and the scheduler (serve/scheduler.py) and
decides; every device call its loop makes is an op of host values
(``BatchScheduler._dev``) that :class:`TPChannel` sends to ranks
1 .. t-1 before rank 0 runs it, and :func:`tp_follower_loop` runs each
op on the follower's own scheduler — built the same way, with no loop
thread, no front and no tokenizer output — so every rank issues the same
kernels and collectives in the same order on its shard.

- An op is a header of three int64 (its id, the index of the engine it
  is for, the length of its blob) and its arguments as one pickled blob
  of host values (row indices, token ids, page tables, lengths, window,
  K, the live mask, sampling options and seeds, prefix ids), both
  broadcast on the gloo control group (parallel/mesh.Mesh.control). It
  never carries a device tensor: the arrays of a KV tier op (a session
  or a prefix entry to place, serve/scheduler._Payload) ride as their
  shapes, and the op itself broadcasts them over ``tp``. Sampling runs
  on every rank from the gathered logits, the same bytes everywhere, so
  no follower reads a token back.
- Several models on the same ranks (``SERVE_MODELS`` under ``SERVE_TP``)
  share one plane: one :class:`TPChannel`, one stream. Each engine's
  index is its tag's position in the spec, which every rank parses the
  same from the same env; :func:`tp_follower_loop` runs each op on the
  engine it names, in arrival order. The leader's engines each run their
  own loop thread, so an op holds the channel's :attr:`TPChannel.lock`
  (first come, first served) from its send to the end of its run on the
  leader: two ops that interleaved would split a header from its blob,
  and would issue their compute collectives in different orders on
  different ranks (gloo then corrupts or deadlocks; NCCL hangs). The
  followers run one op at a time anyway. Lock order: the op lock is
  innermost. It is taken only on an engine's loop thread, by
  ``BatchScheduler._dev``, and nothing run under it waits on another
  thread: no ``run_on_loop`` / ``post_on_loop`` job, no ``park_all``
  handshake (both refuse to wait while their thread holds it:
  :meth:`TPChannel.check_not_holding`) and no capture lock (under tp no
  graph is captured and no device work runs off the loop). So no thread
  holds it while waiting on a lock or a loop that waits for it.
- Every rank folds the tokens each engine sampled into that engine's
  running digest (``BatchScheduler._fold``); at shutdown the ranks
  all-gather every engine's digest over the control group, in engine
  order, and a mismatch is logged as an error (``BatchScheduler.
  digests``).
- Shutdown works as in serve/multihost.py: once every engine of the
  plane has stopped, the leader sends the shutdown op (once), the
  followers compare digests and return, and every rank leaves the world.
  A failure outside an op fails that engine's requests through its
  loop's recovery, whose reset is itself an op, so the followers reset
  it too. An op that fails ends the plane, for every engine on it: a
  rank that stopped partway through an op's collectives cannot rejoin
  the stream (its peers wait in those collectives, or would pair their
  next ones with its leftovers). A follower logs the failure, leaves the
  world and exits non-zero; the leader's collectives then fail, and every
  engine of the leader fails its requests, takes no more and turns not
  ready, and the leader leaves the world (``BatchScheduler._end_plane``,
  :meth:`TPChannel.end_plane`), which ends the other followers' waits.

``python -m p2p_llm_chat_tpu_torch.serve.tp`` is a follower process:
:func:`p2p_llm_chat_tpu_torch.parallel.distributed.start_local_world`
starts ranks 1 .. t-1 so, with the leader's env (``SERVE_TP_WORLD``,
``SERVE_TP_RANK``, ``SERVE_TP_PARENT``, ``SERVE_TP_JOIN_S``: the world,
the rank, the leader's pid and the join timeout); each dies with the
leader.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
from typing import Optional

import torch

from ..utils.log import get_logger
from .scheduler import _OPS

log = get_logger("serve.tp")

# Op ids on the wire: the index in this tuple, the scheduler's device ops
# (serve/scheduler._OPS) after the shutdown op.
OPS = ("shutdown", *_OPS)


class _FairLock:
    """A lock granted in the order it was asked for (a ticket lock): a
    busy engine's loop, which asks again right after each op, cannot
    starve another engine's. :attr:`owner` is the holding thread's id."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._next = 0
        self._serving = 0
        self.owner: Optional[int] = None

    def __enter__(self) -> "_FairLock":
        with self._cv:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cv.wait()
            self.owner = threading.get_ident()
        return self

    def __exit__(self, *exc) -> None:
        with self._cv:
            self.owner = None
            self._serving += 1
            self._cv.notify_all()


class TPChannel:
    """The leader's end of a plane's op stream over ``mesh``'s control
    group, shared by every engine on the plane (:meth:`attach`)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        # Held from an op's send to the end of its run on the leader.
        self.lock = _FairLock()
        # An op failed (BatchScheduler._dev): the stream cannot go on.
        self.down = False
        self._ended = False
        self._closed = False
        # index -> the leader's scheduler of that engine, and the indices
        # whose loops have stopped (cleanly: True).
        self.scheds: dict[int, object] = {}
        self._stopped: dict[int, bool] = {}

    def attach(self, index: int, sched) -> None:
        if index in self.scheds:
            raise ValueError(f"engine index {index} is already on this "
                             "plane")
        self.scheds[index] = sched

    def check_not_holding(self, what: str) -> None:
        """Refuse to wait on a loop while this thread holds the op lock
        (the wait could need the lock: a deadlock)."""
        if self.lock.owner == threading.get_ident():
            raise RuntimeError(f"{what} inside a tensor-parallel op")

    def send(self, op: str, args: tuple, index: int = 0) -> None:
        """Broadcast ``op`` for engine ``index`` and its host arguments to
        every rank (a sync point: it returns once each follower has
        received it). The caller holds :attr:`lock`."""
        blob = pickle.dumps(args, protocol=pickle.HIGHEST_PROTOCOL) \
            if args else b""
        hdr = torch.tensor([OPS.index(op), index, len(blob)],
                           dtype=torch.int64)
        torch.distributed.broadcast(hdr, 0, group=self.mesh.control)
        if blob:
            buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
            torch.distributed.broadcast(buf, 0, group=self.mesh.control)

    def shutdown(self, sched, clean: bool = True) -> None:
        """Engine ``sched`` has stopped (``clean``: its loop thread ended).
        Once every engine of the plane has, send the shutdown op once and
        compare each engine's digests on every rank; nothing is sent after
        the stream went down, or while a loop is stuck in an op (a second
        sender would mix ops on the control group)."""
        index = next(i for i, s in self.scheds.items() if s is sched)
        self._stopped[index] = clean
        if (self._closed or self.down
                or len(self._stopped) < len(self.scheds)):
            return
        self._closed = True
        if not all(self._stopped.values()):
            log.error("a scheduler loop did not stop; the follower ranks "
                      "are not told to shut down")
            return
        with self.lock:
            self.send("shutdown", ())
        for i in sorted(self.scheds):
            compare_digests(self.scheds[i])

    def end_plane(self) -> bool:
        """The plane went down: wake every engine's loop so that each one
        ends its own part (fails its requests, turns not ready). True the
        first time only."""
        self.down = True
        if self._ended:
            return False
        self._ended = True
        for sched in self.scheds.values():
            try:
                sched.post_on_loop(lambda: None)
            except RuntimeError:
                pass                  # already stopped
        return True


def receive(mesh) -> tuple[str, int, tuple]:
    """A follower's next op from the leader: (name, engine index,
    arguments)."""
    hdr = torch.zeros((3,), dtype=torch.int64)
    torch.distributed.broadcast(hdr, 0, group=mesh.control)
    op, index, n = (int(x) for x in hdr)
    args: tuple = ()
    if n:
        buf = torch.empty((n,), dtype=torch.uint8)
        torch.distributed.broadcast(buf, 0, group=mesh.control)
        args = pickle.loads(buf.numpy().tobytes())
    return OPS[op], index, args


def compare_digests(sched) -> bool:
    """All-gather every rank's token digest of ``sched``'s engine over the
    control group (collective); kept on ``sched.digests``. False, logged
    as an error, when they differ."""
    mine = sched.token_digest()
    got: list = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, mine,
                                        group=sched.mesh.control)
    sched.digests = got
    if len(set(got)) != 1:
        log.error("tp ranks sampled different tokens on %s: token digests "
                  "%s", sched.config.name, got)
        return False
    log.info("tp rank %d: token digest %s, equal on all %d ranks",
             sched.mesh.rank, mine, len(got))
    return True


def tp_follower_loop(scheds: dict) -> None:
    """Run on every rank but the leader: receive each op and run it on the
    scheduler of the engine it names (``scheds``: {index: scheduler})
    until the shutdown op, then compare every engine's digests in index
    order. An op that fails is logged and raised: the caller leaves the
    world (``TorchEngine.close``) and the process exits non-zero."""
    mesh = next(iter(scheds.values())).mesh
    log.info("tp follower %d/%d ready (%d engine%s)", mesh.rank, mesh.size,
             len(scheds), "s" * (len(scheds) > 1))
    while True:
        op, index, args = receive(mesh)
        if op == "shutdown":
            for i in sorted(scheds):
                compare_digests(scheds[i])
            log.info("tp follower %d shutting down", mesh.rank)
            return
        try:
            scheds[index].run_op(op, args)
        except Exception:
            log.exception("tp follower %d, engine %d: op %s failed; "
                          "leaving the world (a rank cannot rejoin the op "
                          "stream partway)", mesh.rank, index, op)
            raise


def main() -> int:
    """A follower process of a local tensor-parallel world: die with the
    leader, join its world, build this rank's engine from the leader's
    env (serve/engine.build_engine_from_env) and mirror its ops."""
    from ..parallel.distributed import die_with_parent, init_distributed
    from .engine import build_engine_from_env
    die_with_parent(int(os.environ.get("SERVE_TP_PARENT", "0") or 0))
    init_distributed(coordinator=os.environ["SERVE_TP_WORLD"],
                     num_processes=int(os.environ["SERVE_TP"]),
                     process_id=int(os.environ["SERVE_TP_RANK"]),
                     join_timeout_s=float(os.environ["SERVE_TP_JOIN_S"]))
    eng = build_engine_from_env()
    try:
        eng.follower_loop()
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
