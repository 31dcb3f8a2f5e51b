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

- An op is its id as an int64 and its arguments as one pickled blob of
  host values (row indices, token ids, page tables, lengths, window, K,
  the live mask, sampling options and seeds, prefix ids), both broadcast
  on the gloo control group (parallel/mesh.Mesh.control). It never
  carries a device tensor: the arrays of a KV tier op (a session or a
  prefix entry to place, serve/scheduler._Payload) ride as their shapes,
  and the op itself broadcasts them over ``tp``. Sampling runs on every
  rank from the gathered logits, the same bytes everywhere, so no
  follower reads a token back.
- Every rank folds the tokens it sampled into a running digest
  (``BatchScheduler._fold``); at shutdown the ranks all-gather their
  digests over the control group, and a mismatch is logged as an error
  (``BatchScheduler.digests``).
- Shutdown works as in serve/multihost.py: the leader's stop sends the
  shutdown op, the followers compare digests and return, and every rank
  leaves the world. A failure outside an op fails the leader's requests
  through the loop's recovery, whose reset is itself an op, so the
  followers reset too. An op that fails ends the plane: a rank that
  stopped partway through an op's collectives cannot rejoin the stream
  (its peers wait in those collectives, or would pair their next ones
  with its leftovers). A follower logs the failure, leaves the world and
  exits non-zero; the leader's collectives then fail, and the leader
  fails every request, takes no more and leaves the world
  (``BatchScheduler._end_plane``), which ends the other followers' waits.

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

import torch

from ..utils.log import get_logger
from .scheduler import _OPS

log = get_logger("serve.tp")

# Op ids on the wire: the index in this tuple, the scheduler's device ops
# (serve/scheduler._OPS) after the shutdown op.
OPS = ("shutdown", *_OPS)


class TPChannel:
    """The leader's end of the op stream over ``mesh``'s control group."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        # An op failed (BatchScheduler._dev): the stream cannot go on.
        self.down = False
        self._closed = False

    def send(self, op: str, args: tuple) -> None:
        """Broadcast ``op`` and its host arguments to every rank (a sync
        point: it returns once each follower has received it)."""
        blob = pickle.dumps(args, protocol=pickle.HIGHEST_PROTOCOL) \
            if args else b""
        hdr = torch.tensor([OPS.index(op), len(blob)], dtype=torch.int64)
        torch.distributed.broadcast(hdr, 0, group=self.mesh.control)
        if blob:
            buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
            torch.distributed.broadcast(buf, 0, group=self.mesh.control)

    def shutdown(self, sched) -> None:
        """Send the shutdown op once and compare the ranks' digests (not
        after the stream went down)."""
        if self._closed or self.down:
            return
        self._closed = True
        self.send("shutdown", ())
        compare_digests(sched)


def receive(mesh) -> tuple[str, tuple]:
    """A follower's next op from the leader: (name, arguments)."""
    hdr = torch.zeros((2,), dtype=torch.int64)
    torch.distributed.broadcast(hdr, 0, group=mesh.control)
    op, n = int(hdr[0]), int(hdr[1])
    args: tuple = ()
    if n:
        buf = torch.empty((n,), dtype=torch.uint8)
        torch.distributed.broadcast(buf, 0, group=mesh.control)
        args = pickle.loads(buf.numpy().tobytes())
    return OPS[op], args


def compare_digests(sched) -> bool:
    """All-gather every rank's token digest over the control group
    (collective); kept on ``sched.digests``. False, logged as an error,
    when they differ."""
    mine = sched.token_digest()
    got: list = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, mine,
                                        group=sched.mesh.control)
    sched.digests = got
    if len(set(got)) != 1:
        log.error("tp ranks sampled different tokens: token digests %s",
                  got)
        return False
    log.info("tp rank %d: token digest %s, equal on all %d ranks",
             sched.mesh.rank, mine, len(got))
    return True


def tp_follower_loop(sched) -> None:
    """Run on every rank but the leader: receive each op and run it on
    this rank's scheduler until the shutdown op. An op that fails is
    logged and raised: the caller leaves the world
    (``TorchEngine.close``) and the process exits non-zero."""
    mesh = sched.mesh
    log.info("tp follower %d/%d ready", mesh.rank, mesh.size)
    while True:
        op, args = receive(mesh)
        if op == "shutdown":
            compare_digests(sched)
            log.info("tp follower %d shutting down", mesh.rank)
            return
        try:
            sched.run_op(op, args)
        except Exception:
            log.exception("tp follower %d: op %s failed; leaving the world "
                          "(a rank cannot rejoin the op stream partway)",
                          mesh.rank, op)
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
