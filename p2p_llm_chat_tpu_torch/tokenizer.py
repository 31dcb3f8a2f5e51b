"""Tokenizers for the port's serving stack — the port of
p2p_llm_chat_tpu/tokenizer.py.

- :class:`BPETokenizer` reads HuggingFace ``tokenizer.json`` files (the
  format llama3 and Mixtral checkpoints ship with): vocab and ranked
  merges, GPT-2's byte<->unicode mapping, llama3's pre-tokenization
  regex, added special tokens. Its merge loop runs in the port's native
  core (``csrc/bpe_core.cc``, built on first use by utils/native.py) and
  falls back to the pure-Python loop, with identical output, when the
  core cannot be built; :attr:`BPETokenizer.native` says which.
- :class:`ByteTokenizer`: UTF-8 bytes, for random-init serving.

``load_tokenizer`` picks BPE when a checkpoint directory has a
``tokenizer.json``, else bytes.
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Optional, Protocol, runtime_checkable

from .utils.log import get_logger

log = get_logger("tokenizer")


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


# ---------------------------------------------------------------------------
# Byte-level BPE (HF tokenizer.json)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte<->printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _nl_no_class() -> str:
    """Character-class body for unicode categories Nl+No (letter-like and
    other numbers: ², ½, Ⅻ, ①, …). Python's \\d covers only Nd, but
    llama3's \\p{N} covers Nd∪Nl∪No — these must be in the number branch
    and out of the letters branch or token ids diverge on such inputs.
    Generated from the runtime's own unicodedata tables (~0.2 s, once)."""
    import sys
    import unicodedata
    pts = [cp for cp in range(sys.maxunicode + 1)
           if unicodedata.category(chr(cp)) in ("Nl", "No")]
    ranges = []
    start = prev = pts[0]
    for cp in pts[1:]:
        if cp == prev + 1:
            prev = cp
            continue
        ranges.append((start, prev))
        start = prev = cp
    ranges.append((start, prev))
    esc = lambda c: re.escape(chr(c))  # noqa: E731
    return "".join(esc(a) + ("-" + esc(b) if b > a else "")
                   for a, b in ranges)


_NL_NO = _nl_no_class()

# llama3's pre-tokenization regex (tiktoken cl100k-style), expressed for
# Python's `re` (no possessive quantifiers / \p{..} classes; (?i:...) works).
# The original's unicode classes map as: \p{L} (letters) -> [^\W\d_] minus
# Nl/No (word chars minus all numbers minus underscore); \p{N} (numbers)
# -> [\d + Nl/No]; "not letter, not number" -> [\W_] (digits and Nl/No are
# word chars, so \W already excludes them; underscore added back).
# Keeping numbers out of the word branch is what makes the number branch
# reachable, so digit runs split into <=3-digit groups exactly like the HF
# llama3 tokenizer. Parity with the real \p{..} engine is pinned by
# tests/test_torch_tokenizer.py against the `tokenizers` library.
_PRETOKEN_RE = re.compile(
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    rf"|(?:(?![\r\n])[\W_])?[^\W\d_{_NL_NO}]+"   # [^\r\n\p{{L}}\p{{N}}]?\p{{L}}+
    rf"|[\d{_NL_NO}]{{1,3}}"                      # \p{{N}}{{1,3}}
    r"| ?(?:_|[^\s\w])+[\r\n]*"                   # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)


class BPETokenizer:
    """Byte-level BPE over a ``tokenizer.json``'s vocab, merges and added
    tokens. ``use_native=False`` keeps the pure-Python merge path (the
    tests hold the two paths equal)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 special_tokens: Optional[dict[str, int]] = None,
                 bos_token: str = "<|begin_of_text|>",
                 eos_tokens: tuple[str, ...] = ("<|end_of_text|>", "<|eot_id|>"),
                 use_native: bool = True):
        self._vocab = vocab
        self._inv_vocab = {v: k for k, v in vocab.items()}
        self._ranks = {pair: i for i, pair in enumerate(merges)}
        self._special = dict(special_tokens or {})
        self._inv_special = {v: k for k, v in self._special.items()}
        self._b2u = _byte_to_unicode()
        self._u2b = {v: k for k, v in self._b2u.items()}
        self.vocab_size = max(
            [max(vocab.values(), default=-1)] + list(self._special.values())) + 1
        self.bos_id = self._special.get(bos_token, 0)
        self.eos_id = next((self._special[t] for t in eos_tokens
                            if t in self._special), 0)
        if self._special:
            self._special_re = re.compile(
                "(" + "|".join(re.escape(t) for t in
                               sorted(self._special, key=len, reverse=True)) + ")")
        else:
            self._special_re = None
        self._native = self._init_native() if use_native else None
        log.info("BPE tokenizer: %d ids, %d merges, %d specials; merges on "
                 "the %s path", self.vocab_size, len(self._ranks),
                 len(self._special),
                 "native" if self._native is not None else "pure-Python")

    @property
    def native(self) -> bool:
        """Whether merges run in the native core (else pure Python)."""
        return self._native is not None

    def has_special(self, token: str) -> bool:
        """Whether ``token`` is a registered special (serve/engine.py
        keys the llama3 chat template on the header/eot specials)."""
        return token in self._special

    def strip_specials(self, text: str) -> str:
        """Remove every registered special-token string from ``text``.

        ``encode`` maps special strings ANYWHERE in input to their
        control ids — correct for templates the server renders, but a
        forgery vector for untrusted content (a chat message containing
        ``<|eot_id|><|start_header_id|>system...`` would fabricate a
        system turn). Template renderers call this on user-supplied
        parts before interpolation (serve/engine.py render_chat)."""
        if self._special_re is None:
            return text
        return self._special_re.sub("", text)

    def _init_native(self):
        """Bind the C++ merge core (csrc/bpe_core.cc) when buildable.

        BPE is re-keyed into vocab-id space once here — pair
        (left_id, right_id) -> (rank, merged_id) — so the per-call ctypes
        boundary is plain int32 arrays and the C++ loop never sees
        strings. Returns (lib, handle) or None (pure-Python fallback,
        identical output — pinned by tests/test_torch_tokenizer.py)."""
        import ctypes

        from .utils import native

        lib = native.load("bpe_core")
        if lib is None:
            return None
        keys, vals = [], []
        for (l, r), rank in self._ranks.items():
            li, ri = self._vocab.get(l), self._vocab.get(r)
            mi = self._vocab.get(l + r)
            if li is None or ri is None or mi is None:
                # A merge the id-keyed table can't represent: the Python
                # path would still apply it (then decompose the unknown
                # fragment), so a lossy table would diverge from the
                # pure-Python oracle. Bail to the fallback instead.
                return None
            keys.append((li << 32) | ri)
            vals.append((rank << 32) | mi)
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_new.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.c_int64]
        # Without argtypes ctypes passes the handle as a 32-bit int —
        # pointer truncation, segfault in the finalizer.
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_apply.restype = ctypes.c_int32
        lib.bpe_apply.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32)]
        lib.bpe_apply_batch.restype = ctypes.c_int64
        lib.bpe_apply_batch.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32),
                                        ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_int32,
                                        ctypes.POINTER(ctypes.c_int32)]
        # Direct byte -> initial-symbol-id table: the native path skips
        # the byte->unicode string mapping entirely. Only usable when the
        # vocab covers all 256 byte symbols (true for llama3/Mixtral).
        byte_id = [self._vocab.get(self._b2u[b]) for b in range(256)]
        if any(i is None for i in byte_id):
            return None
        self._byte_id = byte_id
        n = len(keys)
        handle = lib.bpe_new((ctypes.c_uint64 * n)(*keys),
                             (ctypes.c_uint64 * n)(*vals), n)
        if not handle:
            return None
        import weakref
        weakref.finalize(self, lib.bpe_free, handle)
        return (lib, handle, ctypes)

    def _encode_chunk_native(self, chunk: str) -> list[int]:
        """Pre-tokenize + merge one chunk through the C++ core in a single
        FFI call (ids concatenated, one length per piece)."""
        lib, handle, ctypes = self._native
        byte_id = self._byte_id
        flat: list[int] = []
        lens: list[int] = []
        for piece in _PRETOKEN_RE.findall(chunk):
            bs = piece.encode("utf-8")
            flat.extend(byte_id[b] for b in bs)
            lens.append(len(bs))
        if not flat:
            return []
        n = len(flat)
        out = (ctypes.c_int32 * n)()
        m = lib.bpe_apply_batch(handle, (ctypes.c_int32 * n)(*flat),
                                (ctypes.c_int32 * len(lens))(*lens),
                                len(lens), out)
        return list(out[:m])

    # -- loading -------------------------------------------------------------

    @classmethod
    def from_file(cls, path: str, use_native: bool = True) -> "BPETokenizer":
        with open(path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj["model"]
        vocab = model["vocab"]
        merges_raw = model["merges"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in merges_raw]
        specials = {t["content"]: t["id"] for t in tj.get("added_tokens", [])}
        return cls(vocab, merges, specials, use_native=use_native)

    # -- bpe core ------------------------------------------------------------

    def _bpe(self, token: str) -> list[int]:
        if self._native is not None and len(token) > 1:
            ids = [self._vocab.get(ch) for ch in token]
            if None not in ids:       # unknown chars: rare; python fallback
                lib, handle, ctypes = self._native
                n = len(ids)
                buf = (ctypes.c_int32 * n)(*ids)
                out = (ctypes.c_int32 * n)()
                m = lib.bpe_apply(handle, buf, n, out)
                return list(out[:m])
        return self._bpe_py(token)

    def _bpe_py(self, token: str) -> list[int]:
        parts = list(token)
        if len(parts) == 1:
            return [self._vocab[token]] if token in self._vocab else []
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            if p in self._vocab:
                out.append(self._vocab[p])
            else:
                # Unknown fragment: fall back to per-character lookup.
                out.extend(self._vocab[c] for c in p if c in self._vocab)
        return out

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos else []
        chunks = (self._special_re.split(text) if self._special_re else [text])
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self._special:
                ids.append(self._special[chunk])
                continue
            if self._native is not None:
                ids.extend(self._encode_chunk_native(chunk))
                continue
            for piece in _PRETOKEN_RE.findall(chunk):
                mapped = "".join(self._b2u[b] for b in piece.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        return ids

    def decode(self, ids: list[int]) -> str:
        out_bytes = bytearray()
        for i in ids:
            if i in self._inv_special:
                out_bytes += self._inv_special[i].encode("utf-8")
                continue
            tok = self._inv_vocab.get(i)
            if tok is None:
                continue
            for ch in tok:
                b = self._u2b.get(ch)
                if b is not None:
                    out_bytes.append(b)
                else:
                    out_bytes += ch.encode("utf-8")
        return out_bytes.decode("utf-8", "replace")


# ---------------------------------------------------------------------------

def load_tokenizer(ckpt_dir: Optional[str], vocab_size: int = 512) -> Tokenizer:
    """BPE from <ckpt_dir>/tokenizer.json when present; byte fallback
    otherwise (the no-artifacts path tests and synthetic benches use)."""
    if ckpt_dir:
        tj = os.path.join(ckpt_dir, "tokenizer.json")
        if os.path.exists(tj):
            return BPETokenizer.from_file(tj)
    return ByteTokenizer(vocab_size=vocab_size)
