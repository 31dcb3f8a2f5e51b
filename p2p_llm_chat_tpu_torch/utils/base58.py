"""Base58 (bitcoin alphabet) encode/decode.

The port's copy of ``p2p_llm_chat_tpu/utils/base58.py``: the same wire
bytes and behaviour, so port and reference peers mix in one fleet; the
port imports nothing of the reference package.

Peer IDs are base58 strings, matching the textual form libp2p peer IDs take in
the reference's directory records and multiaddrs (go/cmd/node/main.go:177).
Implemented from scratch — no external dependency.
"""

from __future__ import annotations

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def b58encode(data: bytes) -> str:
    # Leading zero bytes encode as '1's.
    n_zeros = len(data) - len(data.lstrip(b"\x00"))
    num = int.from_bytes(data, "big")
    out = []
    while num > 0:
        num, rem = divmod(num, 58)
        out.append(_ALPHABET[rem])
    return "1" * n_zeros + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    n_ones = len(s) - len(s.lstrip("1"))
    num = 0
    for c in s:
        try:
            num = num * 58 + _INDEX[c]
        except KeyError:
            raise ValueError(f"invalid base58 character {c!r}") from None
    body = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    return b"\x00" * n_ones + body
