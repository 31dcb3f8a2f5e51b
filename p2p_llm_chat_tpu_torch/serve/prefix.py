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

Eviction: ``max_bytes`` > 0 switches the store to the cost policy
(bytes x recency, :func:`cost_evict`); ``max_entries`` is a hard cap
either way. ``hits/misses/evictions`` feed /metrics.

Not ported yet: ``export_payload``/``import_payload`` and the
``/admin/prefix*`` endpoints (they come with the session wire).
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

DEFAULT_GRAIN_LADDER = (64, 128, 256, 512)


def token_hash(ids) -> str:
    """Stable identity of a prefix: sha256 over the token ids as
    little-endian int64 words (the reference's bytes, so both hash a
    prefix alike)."""
    ids = list(ids)
    return hashlib.sha256(struct.pack(f"<{len(ids)}q", *ids)).hexdigest()


def cost_evict(items: list[tuple], over_bytes: float,
               now: Optional[float] = None) -> list:
    """Victims until at least ``over_bytes`` bytes are freed. ``items``:
    (key, nbytes, last_used) triples, chosen by descending cost = nbytes x
    idle seconds (floor 1 ms). Returns the victim keys (a copy of the
    reference's serve/kv_tier.cost_evict)."""
    if over_bytes <= 0:
        return []
    t = time.monotonic() if now is None else now
    scored = sorted(items, key=lambda it: it[1] * max(1e-3, t - it[2]),
                    reverse=True)
    victims, freed = [], 0.0
    for key, nbytes, _ in scored:
        if freed >= over_bytes:
            break
        victims.append(key)
        freed += nbytes
    return victims


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
