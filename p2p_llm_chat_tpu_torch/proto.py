"""Chat wire schema.

The port's copy of ``p2p_llm_chat_tpu/proto.py``: the same wire bytes and
behaviour, so port and reference peers mix in one fleet; the port imports
nothing of the reference package.

Reference: ``proto.ChatMessage`` (go/cmd/node/proto/message.go:23-29) — a
single struct with snake_case JSON tags, one JSON-encoded message per peer
stream. We keep the exact field names and JSON shape so directory records,
inbox payloads, and peer streams are wire-compatible with the reference.
"""

from __future__ import annotations

import hashlib
import json
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Optional


def now_rfc3339() -> str:
    """RFC3339/ISO-8601 UTC timestamp, the format Go's time.Time marshals to."""
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


def parse_ts(ts: str) -> datetime:
    """Parse an RFC3339 timestamp, tolerating 'Z' suffix and missing tz.

    Mirrors the UI-side tolerant parser (web/streamlit_app.py:120-127): on
    failure callers should fall back to epoch ordering rather than crash.
    """
    try:
        if ts.endswith("Z"):
            ts = ts[:-1] + "+00:00"
        dt = datetime.fromisoformat(ts)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt
    except (ValueError, AttributeError):
        return datetime.fromtimestamp(0, tz=timezone.utc)


def mint_msg_id(from_user: str, seq: int, content: str,
                nonce: str = "") -> str:
    """Sender-minted delivery identity: sha1 over sender + per-boot
    nonce + per-sender sequence + body. Stable across redelivery
    attempts of the SAME send (the dedup key for at-least-once
    delivery) while distinct sends of identical text still get
    distinct ids via ``seq``. ``nonce`` is a random per-process value
    (node.py mints one per boot): ``seq`` restarts at 0 with the
    process, so without it a post-restart send repeating an earlier
    (seq, content) pair would re-mint an old id and be silently
    dedup-suppressed by any receiver that stayed up."""
    h = hashlib.sha1()
    h.update(from_user.encode("utf-8"))
    h.update(b"\x00")
    h.update(nonce.encode("utf-8"))
    h.update(b"\x00")
    h.update(str(seq).encode("ascii"))
    h.update(b"\x00")
    h.update(content.encode("utf-8"))
    return h.hexdigest()


def ack_frame(msg_id: str) -> bytes:
    """The receiver's delivery acknowledgement, framed back on the same
    chat stream after the message is durably in the inbox. Peers that
    predate the ack (the reference wire) just close; the sender treats
    EOF as legacy-delivered, so the field stays wire-compatible."""
    return json.dumps({"ack": msg_id}).encode("utf-8")


def parse_ack(raw: bytes) -> Optional[str]:
    """Parse an ack frame; None for anything that isn't one."""
    try:
        d = json.loads(raw)
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(d, dict) and isinstance(d.get("ack"), str):
        return d["ack"]
    return None


@dataclass
class ChatMessage:
    """One chat message. JSON keys match go/cmd/node/proto/message.go:23-29.

    ``msg_id`` is additive: a sender-minted delivery identity
    (``mint_msg_id``) used for redelivery dedup. It is omitted from the
    JSON when empty, so streams stay byte-compatible with the reference
    and with pre-msg_id peers in both directions.
    """

    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    from_user: str = ""
    to_user: str = ""
    content: str = ""
    timestamp: str = field(default_factory=now_rfc3339)
    msg_id: str = ""

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "id": self.id,
            "from_user": self.from_user,
            "to_user": self.to_user,
            "content": self.content,
            "timestamp": self.timestamp,
        }
        if self.msg_id:
            d["msg_id"] = self.msg_id
        return d

    def to_json(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ChatMessage":
        return cls(
            id=str(d.get("id", "")),
            from_user=str(d.get("from_user", "")),
            to_user=str(d.get("to_user", "")),
            content=str(d.get("content", "")),
            timestamp=str(d.get("timestamp", "")),
            msg_id=str(d.get("msg_id", "")),
        )

    @classmethod
    def from_json(cls, raw: bytes | str) -> "ChatMessage":
        d = json.loads(raw)
        if not isinstance(d, dict):
            raise ValueError("chat message must be a JSON object")
        return cls.from_dict(d)
