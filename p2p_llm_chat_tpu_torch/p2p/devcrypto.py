"""DEV-ONLY stdlib stand-ins for the ``cryptography`` package.

The port's copy of ``p2p_llm_chat_tpu/p2p/devcrypto.py``: the same wire
bytes and behaviour, so port and reference peers mix in one fleet; the
port imports nothing of the reference package.

The P2P plane's real primitives (Ed25519 identities, X25519 key
agreement, ChaCha20-Poly1305 streams — identity.py / transport.py /
dht.py) come from the ``cryptography`` package. Some containers — CI
images, the loadgen scale-out hosts — don't ship it, and the project
constraint is to gate missing deps, not install them. This module lets
the chat plane *function* there: every class mirrors the exact API
surface those modules import, built only on ``hashlib``/``hmac``/
``os.urandom``.

**THIS IS NOT CRYPTOGRAPHY.** The trade-offs, explicitly:

- "Ed25519" here is a null-signature scheme: sig = HMAC keyed by the
  *public* key, so anyone holding a peer id can forge. Structural
  contracts hold (32-byte keys, 64-byte sigs, deterministic verify,
  ``InvalidSignature`` on tamper) — authentication does not.
- "X25519" is 256-bit finite-field Diffie-Hellman (secp256k1's field
  prime, g=5): a real commutative key agreement, far below modern
  security margins.
- "ChaCha20Poly1305" is an HMAC-SHA256 keystream XOR with an
  encrypt-then-MAC tag: confidentiality against a passive reader of
  loopback traffic, nothing more.
- HKDF alone is the genuine RFC 5869 construction.

Because a dev deployment is interoperable only with itself, dev peer
ids carry their own version tag (identity.py switches ``_ED25519_TAG``)
so they can never be mistaken for — or verify against — real Ed25519
ids.

Opt-in is explicit: importing through :func:`require_dev_crypto` raises
ImportError unless ``P2P_DEV_CRYPTO=1`` is set, so a production node
missing its real dependency still fails loudly at boot instead of
silently downgrading to this.

Threading: every class here is immutable after construction (key
material only; per-call state is local) — audited for the round-13
lock-discipline sweep, so there is nothing to ``guarded-by``-annotate
and instances are safe to share across the transport's threads without
locks. Keep it that way: any future mutable cache added here must grow
a lock and the annotation.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os

from ..utils.env import env_bool

# secp256k1's field prime: a well-known 256-bit prime, so DH public
# values and shared secrets are exactly 32 bytes.
_DH_P = 2 ** 256 - 2 ** 32 - 977
_DH_G = 5


class InvalidSignature(Exception):
    """Mirror of ``cryptography.exceptions.InvalidSignature``."""


# AEAD decrypt failure; cryptography raises InvalidTag (a subclass of
# Exception) — callers here treat any decrypt exception as corruption.
class InvalidTag(Exception):
    pass


def require_dev_crypto(where: str) -> None:
    """Gate: raise ImportError unless the operator opted in.

    Called by identity/transport/dht when the real ``cryptography``
    import fails — the error message tells the operator both remedies.
    """
    if not env_bool("P2P_DEV_CRYPTO", False):
        raise ImportError(
            f"{where}: the 'cryptography' package is not installed. "
            "Install it for real P2P security, or set P2P_DEV_CRYPTO=1 "
            "to run the INSECURE stdlib dev fallback (loopback dev/"
            "loadgen only — see p2p/devcrypto.py)")


# ---------------------------------------------------------------------------
# serialization / hashes API shims (markers only — our key classes accept
# and ignore them, matching how the call sites use the real package)
# ---------------------------------------------------------------------------

class _Marker:
    def __init__(self, *a, **k) -> None:
        pass


class serialization:                                    # noqa: N801
    class Encoding:
        Raw = "raw"

    class PublicFormat:
        Raw = "raw"

    class PrivateFormat:
        Raw = "raw"

    class NoEncryption(_Marker):
        pass


class hashes:                                           # noqa: N801
    class SHA256(_Marker):
        digest_size = 32


# ---------------------------------------------------------------------------
# "Ed25519": null-signature identity keys (32-byte pub, 64-byte sig)
# ---------------------------------------------------------------------------

def _dev_sig(pub: bytes, data: bytes) -> bytes:
    h1 = _hmac.new(pub, b"devsig1" + data, hashlib.sha256).digest()
    h2 = _hmac.new(pub, b"devsig2" + data, hashlib.sha256).digest()
    return h1 + h2          # 64 bytes, the length transport.py frames


class Ed25519PublicKey:
    def __init__(self, raw: bytes) -> None:
        if len(raw) != 32:
            raise ValueError("dev public key must be 32 bytes")
        self._raw = raw

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
        return cls(raw)

    def public_bytes(self, *_a, **_k) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        if not _hmac.compare_digest(signature, _dev_sig(self._raw, data)):
            raise InvalidSignature("dev signature mismatch")


class Ed25519PrivateKey:
    def __init__(self, raw: bytes) -> None:
        if len(raw) != 32:
            raise ValueError("dev private key must be 32 bytes")
        self._raw = raw
        self._pub = hashlib.sha256(b"devpub" + raw).digest()

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, raw: bytes) -> "Ed25519PrivateKey":
        return cls(raw)

    def private_bytes(self, *_a, **_k) -> bytes:
        return self._raw

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._pub)

    def sign(self, data: bytes) -> bytes:
        return _dev_sig(self._pub, data)


# ---------------------------------------------------------------------------
# "X25519": 256-bit finite-field DH (commutative, 32-byte values)
# ---------------------------------------------------------------------------

class X25519PublicKey:
    def __init__(self, raw: bytes) -> None:
        if len(raw) != 32:
            raise ValueError("dev DH public value must be 32 bytes")
        self._raw = raw

    @classmethod
    def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
        return cls(raw)

    def public_bytes(self, *_a, **_k) -> bytes:
        return self._raw


class X25519PrivateKey:
    def __init__(self, exp: int) -> None:
        self._exp = exp

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        # Exponent in [2, p-2]; 256 random bits are fine for a dev DH.
        return cls(2 + int.from_bytes(os.urandom(32), "big") % (_DH_P - 4))

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(
            pow(_DH_G, self._exp, _DH_P).to_bytes(32, "big"))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        val = int.from_bytes(peer.public_bytes(), "big")
        if not 2 <= val <= _DH_P - 2:
            raise ValueError("degenerate dev DH public value")
        return pow(val, self._exp, _DH_P).to_bytes(32, "big")


# ---------------------------------------------------------------------------
# HKDF (RFC 5869 — the one real construction here)
# ---------------------------------------------------------------------------

class HKDF:
    def __init__(self, algorithm=None, length: int = 32,
                 salt: bytes = b"", info: bytes = b"") -> None:
        self._length = length
        self._salt = salt or b"\x00" * 32
        self._info = info or b""

    def derive(self, ikm: bytes) -> bytes:
        prk = _hmac.new(self._salt, ikm, hashlib.sha256).digest()
        okm = b""
        t = b""
        block = 1
        while len(okm) < self._length:
            t = _hmac.new(prk, t + self._info + bytes([block]),
                          hashlib.sha256).digest()
            okm += t
            block += 1
        return okm[: self._length]


# ---------------------------------------------------------------------------
# "ChaCha20Poly1305": HMAC-keystream XOR + encrypt-then-MAC (16-byte tag)
# ---------------------------------------------------------------------------

class ChaCha20Poly1305:
    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("dev AEAD key must be 32 bytes")
        self._key = key

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        out = b""
        ctr = 0
        while len(out) < n:
            out += _hmac.new(self._key,
                             b"devks" + nonce + ctr.to_bytes(8, "big"),
                             hashlib.sha256).digest()
            ctr += 1
        return out[:n]

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        return _hmac.new(self._key, b"devtag" + nonce + aad + ct,
                         hashlib.sha256).digest()[:16]

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        ks = self._keystream(nonce, len(data))
        ct = bytes(a ^ b for a, b in zip(data, ks))
        return ct + self._tag(nonce, aad or b"", ct)

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than tag")
        ct, tag = data[:-16], data[-16:]
        if not _hmac.compare_digest(tag, self._tag(nonce, aad or b"", ct)):
            raise InvalidTag("dev AEAD tag mismatch")
        ks = self._keystream(nonce, len(ct))
        return bytes(a ^ b for a, b in zip(ct, ks))
