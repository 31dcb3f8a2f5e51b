"""Per-node inbox: mutex-guarded append-only message buffer.

The port's copy of ``p2p_llm_chat_tpu/inbox.py``: the same wire bytes and
behaviour, so port and reference peers mix in one fleet; the port imports
nothing of the reference package.

Reference: ``Inbox`` (go/cmd/node/main.go:97-128). Semantics preserved
exactly, including the deliberate quirks documented in SURVEY.md §2:

- append-only: ``drain`` never truncates, so history persists for the life
  of the process and repeated polls with ``after=""`` return everything —
  this is what makes chat history survive UI reloads in the reference.
- ``drain(after)`` with a non-empty ``after``: linear scan for the matching
  message ID, return the suffix strictly after it; an unknown ID returns the
  EMPTY list (main.go:116-127: ``found`` never flips, ``out`` stays empty) —
  a client polling with a stale cursor gets nothing, not duplicate history.

Additive over the reference: messages carrying a sender-minted ``msg_id``
(proto.mint_msg_id) are deduplicated — the at-least-once redelivery wire
(node.py Outbox) may deliver the same send twice (e.g. the ack was lost),
and the second copy must be suppressed so the client sees exactly-once.
Messages without a ``msg_id`` (old peers) keep the reference append-always
behavior.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from .proto import ChatMessage

# Dedup ids remembered past the message cap: a redelivered copy of a
# message the cap already dropped must still be suppressed (it WAS
# delivered once), so ids outlive the messages by this factor.
_DEDUP_PER_MSG = 8

# Standalone dedup-id bound for the uncapped (reference-parity) inbox:
# the message buffer being unbounded is a deliberate reference quirk,
# but the dedup set is pure additive bookkeeping — cap it so
# at-least-once accounting can never OOM a node on its own.
_DEDUP_MAX = 4096


class Inbox:
    def __init__(self, max_messages: Optional[int] = None) -> None:
        """``max_messages`` is an additive safety valve (None = unbounded,
        matching the reference); when set, the oldest messages are dropped
        once the cap is exceeded so a hostile peer can't OOM the node."""
        self._mu = threading.Lock()
        self._msgs: list[ChatMessage] = []        # guarded-by: _mu
        self._max = max_messages
        self._seen: set[str] = set()              # guarded-by: _mu
        self._seen_order: collections.deque[str] = collections.deque()  # guarded-by: _mu

    def push(self, msg: ChatMessage) -> bool:
        """Append ``msg``; returns False when a duplicate ``msg_id`` was
        suppressed (the caller still acks — the original delivery won)."""
        with self._mu:
            if msg.msg_id:
                if msg.msg_id in self._seen:
                    return False
                self._seen.add(msg.msg_id)
                self._seen_order.append(msg.msg_id)
                cap = (_DEDUP_PER_MSG * self._max
                       if self._max is not None else _DEDUP_MAX)
                if len(self._seen_order) > cap:
                    self._seen.discard(self._seen_order.popleft())
            self._msgs.append(msg)
            if self._max is not None and len(self._msgs) > self._max:
                del self._msgs[: len(self._msgs) - self._max]
            return True

    def drain(self, after: str = "") -> list[ChatMessage]:
        with self._mu:
            if after == "":
                return list(self._msgs)
            for i, m in enumerate(self._msgs):
                if m.id == after:
                    return list(self._msgs[i + 1:])
            return []

    def __len__(self) -> int:
        with self._mu:
            return len(self._msgs)
