"""Shared-prefix KV cache for admission — the port's copy of
p2p_llm_chat_tpu/serve/prefix.py (``token_hash``, ``PrefixEntry``,
``PrefixStore``) on torch tensors.

The co-pilot wraps every suggestion in one fixed template, so every
request of the north-star workload begins with the same tokens. A prefix
is prefilled ONCE (kernel D on the card), its per-layer K/V kept on the
device, and admission then prefills only each request's suffix at
positions P.. over the cached prefix (serve/scheduler.py).

Two ways an entry is born:

- **registered**: known templates (``SERVE_PREFIX_TEXTS``; the co-pilot
  template by default), built at warmup at their exact token length;
- **promoted**: :meth:`PrefixStore.observe` counts repeated prompt heads
  at the power-of-two grain ladder; a head seen ``promote_after`` times is
  built between decode ticks.

A third, **imported**: a replica router lists each replica's entries by
token hash (:meth:`PrefixStore.hashes`, ``GET /admin/prefix``) and tells
a replica missing a hot prefix to pull it from one that built it
(:meth:`PrefixStore.export_payload` / :meth:`PrefixStore.import_payload`
over ``/admin/prefix/export`` and ``/admin/prefix/import``). The wire is
the reference's npz: the ids, k/v as float32 (bf16 -> f32 is lossless)
and the entry's dtype name (``"bfloat16"``, ``"float32"``), so entries
move between this port and a JAX replica both ways.

Eviction: ``max_bytes`` > 0 switches the store to the cost policy
(bytes x recency, serve/kv_tier.cost_evict); ``max_entries`` is a hard
cap either way. ``hits/misses/evictions`` feed /metrics.
"""

from __future__ import annotations

import hashlib
import io
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .kv_tier import _WIRE_DTYPES, _WIRE_NAMES, cost_evict

DEFAULT_GRAIN_LADDER = (64, 128, 256, 512)
# Wire-format version of export_payload / import_payload.
_WIRE_VERSION = 1


def token_hash(ids) -> str:
    """Stable identity of a prefix: sha256 over the token ids as
    little-endian int64 words (the reference's bytes, so both hash a
    prefix alike)."""
    ids = list(ids)
    return hashlib.sha256(struct.pack(f"<{len(ids)}q", *ids)).hexdigest()


@dataclass
class PrefixEntry:
    """One cached prefix: ``ids`` (exactly P tokens) and its prefilled
    K/V, each [L, P, Hkv, D] on the device."""

    ids: tuple[int, ...]
    k: torch.Tensor
    v: torch.Tensor
    hits: int = 0
    last_used: float = field(default_factory=time.monotonic)

    @property
    def length(self) -> int:
        return len(self.ids)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v)
                   if t is not None)

    @property
    def token_hash(self) -> str:
        return token_hash(self.ids)


class PrefixStore:
    """Keyed by the exact token tuple; :meth:`match` finds the longest
    cached prefix of a prompt, :meth:`observe` drives auto-promotion."""

    def __init__(self, grain_ladder: tuple[int, ...] = DEFAULT_GRAIN_LADDER,
                 max_entries: int = 8, promote_after: int = 2,
                 max_tracked: int = 256, max_bytes: int = 0) -> None:
        self.grain_ladder = tuple(sorted(grain_ladder))
        self.max_entries = max_entries
        self.promote_after = promote_after
        self.max_tracked = max_tracked
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: dict[tuple[int, ...], PrefixEntry] = {}
        # head tuple -> times seen (insertion-ordered; trimmed FIFO).
        self._seen: dict[tuple[int, ...], int] = {}
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def match(self, ids: list[int]) -> Optional[PrefixEntry]:
        """Longest entry that is a proper prefix of ``ids`` (at least one
        suffix token must remain to prefill — its logits seed sampling)."""
        with self._lock:
            best: Optional[PrefixEntry] = None
            for key, entry in self._entries.items():
                P = len(key)
                if P < len(ids) and tuple(ids[:P]) == key:
                    if best is None or P > best.length:
                        best = entry
            if best is not None:
                best.hits += 1
                best.last_used = time.monotonic()
                self.hits_total += 1
            else:
                self.misses_total += 1
            return best

    def observe(self, ids: list[int]) -> Optional[tuple[int, ...]]:
        """Count this prompt's heads at every ladder grain; return a head
        that just crossed ``promote_after`` sightings (the longest), else
        None. Grains covered by a longer matching entry are not tracked
        (match() would never use a shorter one)."""
        candidate: Optional[tuple[int, ...]] = None
        with self._lock:
            covered = 0
            for key in self._entries:
                lk = len(key)
                if covered < lk < len(ids) and tuple(ids[:lk]) == key:
                    covered = lk
            for g in self.grain_ladder:
                if g >= len(ids):       # need >= 1 suffix token
                    break
                if g <= covered:
                    continue
                head = tuple(ids[:g])
                if head in self._entries:
                    continue
                n = self._seen.get(head, 0) + 1
                self._seen[head] = n
                if n >= self.promote_after:
                    candidate = head    # longest qualifying grain wins
            while len(self._seen) > self.max_tracked:
                self._seen.pop(next(iter(self._seen)))
            if candidate is not None:
                del self._seen[candidate]
        return candidate

    def put(self, entry: PrefixEntry) -> None:
        """Insert (idempotent), then evict down to policy: the byte budget
        first when ``max_bytes`` is set (cost = bytes x recency; the new
        entry never evicts itself), then the ``max_entries`` count cap
        (least recently used first)."""
        with self._lock:
            self._entries[entry.ids] = entry
            if self.max_bytes:
                over = (sum(e.nbytes for e in self._entries.values())
                        - self.max_bytes)
                if over > 0:
                    items = [(e.ids, e.nbytes, e.last_used)
                             for e in self._entries.values()
                             if e.ids != entry.ids]
                    for ids in cost_evict(items, over):
                        del self._entries[ids]
                        self.evictions_total += 1
            while len(self._entries) > self.max_entries:
                lru = min(self._entries.values(), key=lambda e: e.last_used)
                del self._entries[lru.ids]
                self.evictions_total += 1

    def lengths(self) -> list[int]:
        """Distinct cached prefix lengths."""
        with self._lock:
            return sorted({len(k) for k in self._entries})

    def snapshot(self) -> list[PrefixEntry]:
        with self._lock:
            return list(self._entries.values())

    # -- cross-replica shared tier -----------------------------------------

    def hashes(self) -> dict[str, dict]:
        """{token_hash: {"len": P, "hits": n}} for every cached entry (GET
        /admin/prefix: no KV bytes)."""
        with self._lock:
            return {e.token_hash: {"len": e.length, "hits": e.hits}
                    for e in self._entries.values()}

    def export_payload(self, h: str, gather=None) -> Optional[bytes]:
        """One entry (by token hash) for a peer replica: ids and k/v as
        float32 with the entry's dtype name, in an npz. None = not
        cached. ``gather(entry)``: the entry's (k, v) with every kv head
        where the entry holds a shard of them (tensor parallelism). The
        members are stored, not deflated: deflating a 512-token
        llama3.1-8b entry (134 MB of f32) takes 30 s or more of host CPU,
        past the 30 s a peer's pull waits; ``np.load`` reads either form,
        the reference's importer included."""
        with self._lock:
            entry = next((e for e in self._entries.values()
                          if e.token_hash == h), None)
        if entry is None:
            return None
        k, v = (entry.k, entry.v) if gather is None else gather(entry)
        buf = io.BytesIO()
        np.savez(
            buf, version=np.int64(_WIRE_VERSION),
            ids=np.asarray(entry.ids, np.int64),
            dtype=np.bytes_(_WIRE_NAMES[entry.k.dtype].encode()),
            k=k.detach().float().cpu().numpy(),
            v=v.detach().float().cpu().numpy())
        return buf.getvalue()

    def import_payload(self, data: bytes,
                       device: Optional[torch.device | str] = None,
                       geometry: Optional[tuple[int, int, int]] = None,
                       place=None) -> Optional[PrefixEntry]:
        """Install a peer's exported entry on ``device`` in the payload's
        dtype (idempotent: a cached head is replaced by the same KV).
        Returns the entry, or None on a malformed or other-version
        payload, or one whose k/v are not ``geometry`` = (layers, kv
        heads, head dim) when given. ``place(ids, k, v)``: the entry's
        (k, v) on the device from the whole host arrays in the entry's
        dtype, where the entry holds a shard of the heads (tensor
        parallelism)."""
        try:
            with np.load(io.BytesIO(data)) as z:
                if int(z["version"]) != _WIRE_VERSION:
                    return None
                ids = tuple(int(t) for t in z["ids"])
                dtype = _WIRE_DTYPES[z["dtype"].tobytes().decode()]
                k = torch.from_numpy(np.array(z["k"], np.float32))
                v = torch.from_numpy(np.array(z["v"], np.float32))
        except Exception:   # noqa: BLE001 — peer payloads are untrusted
            return None
        if not ids or k.ndim != 4 or k.shape != v.shape \
                or k.shape[1] != len(ids):
            return None
        if geometry is not None and (k.shape[0], *k.shape[2:]) != tuple(
                geometry):
            return None
        if place is None:
            k, v = k.to(device=device, dtype=dtype), v.to(device=device,
                                                          dtype=dtype)
        else:
            k, v = place(ids, k.to(dtype), v.to(dtype))
        entry = PrefixEntry(ids=ids, k=k, v=v)
        self.put(entry)
        return entry
