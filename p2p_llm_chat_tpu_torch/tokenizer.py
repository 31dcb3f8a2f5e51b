"""Tokenizers for the port's serving stack.

A copy of the reference's ``Tokenizer`` protocol and dependency-free
``ByteTokenizer`` (p2p_llm_chat_tpu/tokenizer.py). The byte-level BPE
tokenizer arrives with checkpoint loading in a later slice; random-init
serving uses bytes, exactly as the reference does with no checkpoint.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as ids 0..255; bos=256, eos=257, pad=258."""

    def __init__(self, vocab_size: int = 512) -> None:
        if vocab_size < 259:
            raise ValueError("byte tokenizer needs vocab_size >= 259")
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")
