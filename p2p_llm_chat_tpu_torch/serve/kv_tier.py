"""Multi-tier KV: sessions that outlive a request — the port's copy of
p2p_llm_chat_tpu/serve/kv_tier.py (``HEAD_GRAIN``, ``head_key``,
``cost_evict``, ``SessionKV``, the session wire format and ``KVTier``)
on torch tensors.

A conversation's next turn re-sends the whole history. With the tier on
(``SERVE_KV_HOST_GB`` > 0) the scheduler keeps a finished request's KV
open as a session instead (serve/scheduler.py):

- **resident**: a finished request whose client named a session (or
  whose prompt head is long enough to index) keeps its physical pages in
  the pool; its row is released and its table zeroed, but the pages stay
  out of the allocator. A follow-up whose prompt extends the session's
  tokens wakes: the pages re-enter a fresh row's table and only the new
  turn's suffix runs a forward (a verify-shaped one: kernel B's verify
  mode on the card).
- **parked**: under idle timeout, page-pool pressure or
  ``/admin/session/park_all`` the session's raw pool words (int8 values
  and head-major scales included — never a requantize) are gathered in
  one device operation and copied to host tensors; the pages go back to
  the allocator. A wake uploads the payload (the copy starts when the
  request is matched) and scatters it into new pages.
- over the dense cache (the reference's default layout) a session has
  no resident phase: the finished row's first slots (a power-of-two
  bucket of its length) are copied to host tensors at once, and a wake
  copies them back into a free row.
- **evicted**: the host pool is budgeted; the cost policy below drops
  the worst parked sessions entirely, and their follow-up admits cold.

Eviction cost = bytes x idle seconds (shared with serve/prefix.py's byte
budget). Park/wake moves the exact pool words, so a resumed greedy
stream equals one whose session never left the card.

Host payloads are CPU tensors, so every pool dtype — bf16 included — is
held without ``ml_dtypes``. The wire format is the reference's, member
for member: raw bytes plus dtype-name and shape sidecars in an npz, bf16
moving as its raw 2-byte words under the name ``"bfloat16"``. The port
stores the members where the reference deflates them (``np.load`` reads
either): deflating a dense llama3.1-8b session of 268 MB outlasts the
30 s a peer's pull waits. A payload written here imports into a JAX
replica and the reverse.

Threading: the scheduler thread performs every state transition; the
/metrics and /admin/session readers take the index lock.
"""

from __future__ import annotations

import hashlib
import io
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils.failpoints import failpoint
from ..utils.log import get_logger

log = get_logger("serve.kv_tier")

# Wire-format version (importers reject any other rather than guess).
_WIRE_VERSION = 1

# Sessions of at least this many tokens are findable by the hash of their
# first HEAD_GRAIN token ids, so a bare /api/generate context continuation
# wakes without a session id; shorter ones only by explicit id.
HEAD_GRAIN = 32

# Dtype names on the wire (numpy's spelling, as the reference writes
# them) and the torch dtype each one is held in here.
_WIRE_DTYPES = {
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "bool": torch.bool,
}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def head_key(ids) -> Optional[str]:
    """The anonymous session index key: ``head:`` + sha1 over the native
    int64 bytes of the first HEAD_GRAIN token ids, or None when too short
    to index. The one derivation the retention key, the router's affinity
    key and the disaggregated-prefill key share."""
    if len(ids) < HEAD_GRAIN:
        return None
    return "head:" + hashlib.sha1(np.asarray(
        ids[:HEAD_GRAIN], np.int64).tobytes()).hexdigest()[:16]


def cost_evict(items: list[tuple], over_bytes: float,
               now: Optional[float] = None) -> list:
    """Victims until at least ``over_bytes`` bytes are freed. ``items``:
    (key, nbytes, last_used) triples, chosen by descending cost = nbytes x
    idle seconds (floor 1 ms, so entries touched this instant still rank
    by size). Returns the victim keys; the caller removes them. Shared by
    the host session pool and the PrefixStore byte budget."""
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


def tensor_nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclass
class SessionKV:
    """One open session's KV, in whichever tier it occupies.

    ``tokens``: the ids whose KV is trusted (prompt + all generated but
    the last); ``length`` == len(tokens). Exactly one of ``pages``
    (resident: physical page ids) and ``host`` (parked) is set; ``host``
    is ((k, v, k_scale, v_scale), n_pages) for a paged pool — CPU tensors,
    the scale pair None on bf16 pools — or ((k, v), width) for a dense row
    (``[L, width, Hkv, D]`` each; a dense session is parked from its
    start)."""

    key: str
    tokens: tuple
    length: int
    pages: Optional[list] = None
    host: Optional[tuple] = None
    nbytes: int = 0
    last_used: float = field(default_factory=time.monotonic)

    @property
    def parked(self) -> bool:
        return self.host is not None


# -- cross-replica session wire format ---------------------------------------

def _raw_bytes(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(uint8 bytes, wire dtype name) of a tensor: its raw words in
    memory order."""
    t = t.detach().to("cpu").contiguous()
    name = _WIRE_NAMES.get(t.dtype)
    if name is None:
        raise ValueError(f"no wire name for dtype {t.dtype}")
    return t.reshape(-1).view(torch.uint8).numpy(), name


def serialize_session(sess: SessionKV) -> bytes:
    """One PARKED session -> bytes for a peer replica: the raw pool words
    and scales exactly as parked, the token ids and the index key.
    ``kind`` names the pool family ("paged": span = page count; "dense":
    span = the row's bucket width). The npz members are stored, not
    deflated (the module's note)."""
    assert sess.parked, "only parked sessions serialize (park first)"
    arrays, span = sess.host
    kind = "paged" if len(arrays) == 4 else "dense"
    present = [a is not None for a in arrays]
    payload = {}
    for i, a in enumerate(arrays):
        if a is None:
            continue
        raw, name = _raw_bytes(a)
        payload[f"a{i}"] = raw
        payload[f"a{i}_dtype"] = np.bytes_(name.encode())
        payload[f"a{i}_shape"] = np.asarray(tuple(a.shape), np.int64)
    buf = io.BytesIO()
    np.savez(
        buf, version=np.int64(_WIRE_VERSION),
        key=np.bytes_(sess.key.encode()),
        kind=np.bytes_(kind.encode()),
        tokens=np.asarray(sess.tokens, np.int64),
        length=np.int64(sess.length), span=np.int64(span),
        present=np.asarray(present, bool), **payload)
    return buf.getvalue()


def _from_raw(raw: bytes, name: str, shape: tuple) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` (wire spelling) and ``shape`` over
    the raw words ``raw`` (copied: the npz buffer is not kept)."""
    dtype = _WIRE_DTYPES[name]
    words = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return words.view(dtype).reshape(shape)


def deserialize_session(data: bytes) -> Optional[SessionKV]:
    """Bytes -> a parked :class:`SessionKV`, or None on a malformed or
    other-version payload (peer payloads are untrusted input and never
    raise into the serving plane). Geometry against the adopting pool is
    the scheduler's check (``session_import``)."""
    try:
        with np.load(io.BytesIO(data)) as z:
            if int(z["version"]) != _WIRE_VERSION:
                return None
            key = z["key"].tobytes().decode()
            kind = z["kind"].tobytes().decode()
            tokens = tuple(int(t) for t in z["tokens"])
            length = int(z["length"])
            span = int(z["span"])
            present = [bool(p) for p in z["present"]]
            arrays = []
            for i, p in enumerate(present):
                if not p:
                    arrays.append(None)
                    continue
                arrays.append(_from_raw(
                    z[f"a{i}"].tobytes(),
                    z[f"a{i}_dtype"].tobytes().decode(),
                    tuple(int(s) for s in z[f"a{i}_shape"])))
            arrays = tuple(arrays)
    except Exception:   # noqa: BLE001 — peer payloads are untrusted
        return None
    if (not key or kind not in ("paged", "dense") or span <= 0
            or not (0 < length <= len(tokens))
            or not arrays or arrays[0] is None
            or (kind == "paged" and len(arrays) != 4)
            or (kind == "dense" and len(arrays) != 2)):
        return None
    return SessionKV(key=key, tokens=tokens, length=length,
                     host=(arrays, span),
                     nbytes=sum(tensor_nbytes(a) for a in arrays))


class KVTier:
    """Session index and host-pool budget accounting (the reference's
    ``KVTier``). State transitions run on the scheduler thread, which owns
    the device buffers they copy; the lock serves the readers."""

    def __init__(self, host_bytes: float, idle_s: float = 30.0,
                 max_sessions: int = 4096) -> None:
        self.host_budget = float(host_bytes)
        self.idle_s = idle_s
        self.max_sessions = max_sessions
        self._mu = threading.Lock()
        self._sessions: dict[str, SessionKV] = {}   # guarded-by: _mu
        self._by_head: dict[tuple, str] = {}        # guarded-by: _mu
        self.host_bytes = 0                         # guarded-by: _mu
        self.n_parked_total = 0       # guarded-by: _mu
        self.n_waked_total = 0        # guarded-by: _mu
        self.n_wake_cold_total = 0    # guarded-by: _mu — follow-ups that found no session
        self.n_wake_tokens_total = 0  # guarded-by: _mu — prompt tokens a wake did not prefill
        self.n_evicted_total = 0      # guarded-by: _mu
        self.n_pages_freed_total = 0  # guarded-by: _mu — pages released by parking
        # Tier-event observer (the scheduler's flight recorder), always
        # called outside ``_mu``.
        self.observer = None

    def _notify(self, kind: str, **meta) -> None:
        cb = self.observer
        if cb is not None:
            try:
                cb(kind, **meta)
            except Exception:   # noqa: BLE001 — observability never faults the tier
                pass

    # -- index ---------------------------------------------------------------

    @staticmethod
    def _head(tokens) -> Optional[tuple]:
        if len(tokens) < HEAD_GRAIN:
            return None
        return tuple(tokens[:HEAD_GRAIN])

    def _unindex(self, s: SessionKV) -> None:
        """Drop ``s`` from the head index (caller holds ``_mu``)."""
        h = self._head(s.tokens)
        if h is not None and self._by_head.get(h) == s.key:
            del self._by_head[h]

    def counts(self) -> tuple[int, int]:
        """(resident, parked) session counts."""
        with self._mu:
            parked = sum(1 for s in self._sessions.values() if s.parked)
            return len(self._sessions) - parked, parked

    def resident_sessions(self) -> list[SessionKV]:
        """Resident sessions, least recently used first."""
        with self._mu:
            res = [s for s in self._sessions.values() if not s.parked]
        return sorted(res, key=lambda s: s.last_used)

    def lookup(self, key: str, prompt_ids: list,
               count_miss: bool = True) -> Optional[SessionKV]:
        """The session whose tokens are a PROPER prefix of ``prompt_ids``
        (at least one suffix token must remain: its logits seed sampling),
        by explicit key first, else by the token-head index. A key match
        whose content diverged (the client edited history) is dropped.
        Misses count toward ``kv_wake_cold_total`` when a session was
        plausibly being continued and ``count_miss`` is set."""
        with self._mu:
            s = self._sessions.get(key) if key else None
            if s is None:
                h = self._head(prompt_ids)
                if h is not None:
                    s = self._sessions.get(self._by_head.get(h, ""))
        indexable = bool(key) or self._head(prompt_ids) is not None
        if s is None:
            if count_miss and indexable:
                with self._mu:
                    self.n_wake_cold_total += 1
            return None
        if not (0 < s.length < len(prompt_ids)
                and tuple(prompt_ids[: s.length]) == s.tokens):
            if key and s.key == key:
                self.drop(s)        # diverged history: stale forever
            if count_miss and indexable:
                with self._mu:
                    self.n_wake_cold_total += 1
            return None
        s.last_used = time.monotonic()
        return s

    def insert(self, sess: SessionKV) -> None:
        """Register (or replace) a session; callers :meth:`take` an older
        entry under the same key first."""
        with self._mu:
            self._sessions[sess.key] = sess
            h = self._head(sess.tokens)
            if h is not None:
                self._by_head[h] = sess.key
            if sess.parked:
                self.host_bytes += sess.nbytes

    def take(self, key: str) -> Optional[SessionKV]:
        """Remove and return a session; the caller owns its pages or
        payload."""
        with self._mu:
            s = self._sessions.pop(key, None)
            if s is None:
                return None
            self._unindex(s)
            if s.parked:
                self.host_bytes -= s.nbytes
            return s

    def claim(self, key: str, prompt_ids: list) -> Optional[SessionKV]:
        """Validated take (the wake's claim): the session only if it still
        extends ``prompt_ids``; None = it vanished or diverged since
        matching, and the request admits cold."""
        s = self.lookup(key, prompt_ids, count_miss=False)
        if s is None:
            return None
        return self.take(s.key)

    def drop(self, sess: SessionKV) -> Optional[list]:
        """Evict a session; returns its resident pages for the caller to
        free (None if it was parked or absent)."""
        s = self.take(sess.key)
        if s is None:
            return None
        with self._mu:
            self.n_evicted_total += 1
        self._notify("evict", key=sess.key)
        return s.pages

    # -- cross-replica migration ---------------------------------------------

    def sessions_meta(self) -> dict[str, dict]:
        """{key: {len, nbytes, parked, idle_s}} (GET /admin/session)."""
        with self._mu:
            now = time.monotonic()
            return {k: {"len": s.length, "nbytes": int(s.nbytes),
                        "parked": s.parked,
                        "idle_s": round(now - s.last_used, 3)}
                    for k, s in self._sessions.items()}

    def export_payload(self, key: str) -> Optional[bytes]:
        """Serialize one PARKED session for a peer; None when absent or
        still resident. The session is retained: a migration removes it
        only on the destination's ack (:meth:`forget`)."""
        failpoint("serve.kv_tier.export")
        with self._mu:
            s = self._sessions.get(key)
            if s is None or not s.parked:
                return None
        # Parked payloads are never mutated in place: serialize unlocked.
        return serialize_session(s)

    def adopt(self, sess: SessionKV) -> bool:
        """Install an imported (parked) session. False when a RESIDENT
        session holds the key (live device state, strictly fresher; only
        the scheduler thread may free its pages). A parked local copy is
        replaced under one lock hold. The host budget is enforced over
        parked victims inline."""
        with self._mu:
            old = self._sessions.get(sess.key)
            if old is not None and not old.parked:
                return False
            if old is not None:
                self._unindex(old)
                del self._sessions[old.key]
                self.host_bytes -= old.nbytes
            self._sessions[sess.key] = sess
            h = self._head(sess.tokens)
            if h is not None:
                self._by_head[h] = sess.key
            self.host_bytes += sess.nbytes
        for victim in self.host_victims():      # parked by definition
            self.drop(victim)
        self._notify("adopt", key=sess.key, nbytes=int(sess.nbytes))
        return True

    def forget(self, key: str) -> bool:
        """Drop a PARKED session without counting an eviction (the
        migration ack). Resident sessions refuse."""
        with self._mu:
            s = self._sessions.get(key)
            if s is None or not s.parked:
                return False
            self._unindex(s)
            del self._sessions[key]
            self.host_bytes -= s.nbytes
        self._notify("forget", key=key)
        return True

    # -- counters --------------------------------------------------------------

    def note_parked(self, pages_freed: int = 0) -> None:
        with self._mu:
            self.n_parked_total += 1
            self.n_pages_freed_total += pages_freed
        self._notify("park", pages_freed=pages_freed)

    def note_waked(self, n: int, tokens_saved: int = 0) -> None:
        with self._mu:
            self.n_waked_total += n
            self.n_wake_tokens_total += tokens_saved
        self._notify("wake", n=n, tokens_saved=tokens_saved)

    def stats(self) -> dict[str, float]:
        """One locked snapshot of the counters and the host pool."""
        with self._mu:
            return {
                "host_bytes": self.host_bytes,
                "parked_total": self.n_parked_total,
                "waked_total": self.n_waked_total,
                "wake_cold_total": self.n_wake_cold_total,
                "wake_tokens_total": self.n_wake_tokens_total,
                "evicted_total": self.n_evicted_total,
                "pages_freed_total": self.n_pages_freed_total,
            }

    # -- policy --------------------------------------------------------------

    def park_candidates(self, now: Optional[float] = None,
                        force: bool = False) -> list[SessionKV]:
        """Resident sessions due for parking: idle past ``idle_s`` (every
        resident session when ``force``), oldest first."""
        t = time.monotonic() if now is None else now
        return [s for s in self.resident_sessions()
                if force or (t - s.last_used) >= self.idle_s]

    def host_victims(self) -> list[SessionKV]:
        """Parked sessions the byte budget says must go, worst cost
        first."""
        with self._mu:
            over = self.host_bytes - self.host_budget
            if over <= 0:
                return []
            items = [(s.key, s.nbytes, s.last_used)
                     for s in self._sessions.values() if s.parked]
            by_key = dict(self._sessions)
        return [by_key[k] for k in cost_evict(items, over)]

    def overflow_victims(self) -> list[SessionKV]:
        """Sessions past the index cap, least recently used first."""
        with self._mu:
            over = len(self._sessions) - self.max_sessions
            if over <= 0:
                return []
            ordered = sorted(self._sessions.values(),
                             key=lambda s: s.last_used)
        return ordered[:over]

    def reset_resident(self) -> None:
        """Drop every RESIDENT session (the pool and allocator were reset,
        so their page ids are dangling); parked payloads survive."""
        with self._mu:
            dead = [s for s in self._sessions.values() if not s.parked]
            for s in dead:
                del self._sessions[s.key]
                self._unindex(s)
        if dead:
            log.warning("dropped %d resident session(s) on device reset",
                        len(dead))
