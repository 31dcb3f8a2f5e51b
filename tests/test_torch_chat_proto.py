"""The port's chat-plane wire and state against the reference's, on the
same seeded inputs: ChatMessage JSON, msg ids and ack frames, base58,
multiaddrs, identities and their key files (both ways), the dev crypto
stand-ins' bytes, and Inbox listings under duplicates."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from p2p_llm_chat_tpu import inbox as ref_inbox
from p2p_llm_chat_tpu import proto as ref_proto
from p2p_llm_chat_tpu.p2p import addr as ref_addr
from p2p_llm_chat_tpu.p2p import devcrypto as ref_dev
from p2p_llm_chat_tpu.p2p import identity as ref_ident
from p2p_llm_chat_tpu.utils import base58 as ref_b58
from p2p_llm_chat_tpu_torch import inbox as port_inbox
from p2p_llm_chat_tpu_torch import proto as port_proto
from p2p_llm_chat_tpu_torch.p2p import addr as port_addr
from p2p_llm_chat_tpu_torch.p2p import devcrypto as port_dev
from p2p_llm_chat_tpu_torch.p2p import identity as port_ident
from p2p_llm_chat_tpu_torch.utils import base58 as port_b58

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hi", "dinner at 8?", "naïve café ☕", "quote \" and \\ slash",
         "line\nbreak", ""]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _rand_bytes(rng, n):
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chat_message_json_msg_id_and_ack_equal(seed):
    rng = _rng(seed)
    for i, text in enumerate(TEXTS):
        fields = dict(id=f"{seed}-{i}", from_user="najy", to_user="cannan",
                      content=text, timestamp="2026-10-18T17:00:00.5Z")
        seq = int(rng.integers(0, 1 << 31))
        nonce = _rand_bytes(rng, 8).hex()
        ids = [m.mint_msg_id("najy", seq, text, nonce=nonce)
               for m in (ref_proto, port_proto)]
        assert ids[0] == ids[1]
        for msg_id in ("", ids[0]):
            a = ref_proto.ChatMessage(msg_id=msg_id, **fields)
            b = port_proto.ChatMessage(msg_id=msg_id, **fields)
            assert a.to_json() == b.to_json()
            # Each package reads the other's bytes back to the same message.
            assert (port_proto.ChatMessage.from_json(a.to_json()).to_dict()
                    == a.to_dict())
            assert (ref_proto.ChatMessage.from_json(b.to_json()).to_dict()
                    == b.to_dict())
        assert ref_proto.ack_frame(ids[0]) == port_proto.ack_frame(ids[0])
        for raw in (ref_proto.ack_frame(ids[0]), b"{}", b"\xff",
                    b'{"ack": 3}', b"[1]"):
            assert ref_proto.parse_ack(raw) == port_proto.parse_ack(raw)


def test_timestamps_parse_alike():
    for ts in ("2026-10-18T17:00:00Z", "2026-10-18T17:00:00.123456+00:00",
               "2026-10-18T17:00:00", "garbage", port_proto.now_rfc3339()):
        assert ref_proto.parse_ts(ts) == port_proto.parse_ts(ts)
    assert port_proto.now_rfc3339().endswith("Z")


@pytest.mark.parametrize("n", [0, 1, 2, 5, 32, 34, 100])
def test_base58_equal_on_random_bytes(n):
    rng = _rng(n)
    for zeros in (0, 1, 3):
        data = b"\x00" * zeros + _rand_bytes(rng, n)
        enc = port_b58.b58encode(data)
        assert enc == ref_b58.b58encode(data)
        assert port_b58.b58decode(enc) == data == ref_b58.b58decode(enc)


def test_base58_known_vector_and_bad_character():
    assert port_b58.b58encode(b"hello world") == "StV1DL6CwTryKyV"
    assert port_b58.b58decode("StV1DL6CwTryKyV") == b"hello world"
    for mod in (ref_b58, port_b58):
        with pytest.raises(ValueError, match="invalid base58"):
            mod.b58decode("0OIl")


ADDRS = [
    "/ip4/127.0.0.1/tcp/4001",
    "/ip4/10.0.0.7/tcp/4001/p2p/12D3KooWabc",
    "/ip4/1.2.3.4/tcp/4100/p2p/RELAYid/p2p-circuit/p2p/TARGETid",
    "/ip4/1.2.3.4/udp/4001/quic-v1/p2p/QUICid",
    "/ip4/1.2.3.4/udp/4001/quic",
    "/dns4/relay.example/tcp/443/p2p/R/p2p-circuit/p2p/T",
]
BAD_ADDRS = ["/ip4/1.2.3.4", "/ip4/1.2.3.4/tcp/1/p2p/R/p2p-circuit",
             "/ip4/1.2.3.4/sctp/5", "/tcp/80"]


@pytest.mark.parametrize("text", ADDRS)
def test_multiaddr_parse_format_equal(text):
    a = ref_addr.Multiaddr.parse(text)
    b = port_addr.Multiaddr.parse(text)
    assert vars(a) == vars(b)
    assert str(a) == str(b)
    assert vars(port_addr.Multiaddr.parse(str(b))) == vars(b)
    assert str(a.with_peer("P")) == str(b.with_peer("P"))
    assert str(a.circuit_via("R2")) == str(b.circuit_via("R2"))


@pytest.mark.parametrize("text", BAD_ADDRS)
def test_multiaddr_rejects_alike(text):
    for mod in (ref_addr, port_addr):
        with pytest.raises(ValueError):
            mod.Multiaddr.parse(text)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_identity_from_the_same_key_and_key_file_both_ways(seed, tmp_path):
    raw = _rand_bytes(_rng(seed), 32)
    ref_key = ref_ident.Ed25519PrivateKey.from_private_bytes(raw)
    port_key = port_ident.Ed25519PrivateKey.from_private_bytes(raw)
    a, b = ref_ident.Identity(ref_key), port_ident.Identity(port_key)
    assert a.peer_id == b.peer_id
    assert a.public_bytes == b.public_bytes
    assert a.sign(b"hs1 transcript") == b.sign(b"hs1 transcript")
    pub = port_ident.peer_id_to_public_key(a.peer_id)
    pub.verify(a.sign(b"x"), b"x")
    # A key file written by either package loads in the other.
    for writer, reader in ((ref_ident, port_ident), (port_ident, ref_ident)):
        path = str(tmp_path / f"{writer.__name__}.key")
        made = writer.Identity.load_or_generate(path)
        with open(path, "rb") as f:
            assert len(f.read()) == 32
        assert os.stat(path).st_mode & 0o777 == 0o600
        assert reader.Identity.load_or_generate(path).peer_id == made.peer_id
    with pytest.raises(ValueError):
        port_ident.peer_id_to_public_key(ref_b58.b58encode(b"\x01\xee" + raw))


_DEV_IDS = """
import json, sys
sys.modules["cryptography"] = None      # as in a host without it
from p2p_llm_chat_tpu.p2p import identity as r
from p2p_llm_chat_tpu_torch.p2p import identity as p
raw = bytes.fromhex(sys.argv[1])
a = r.Identity(r.Ed25519PrivateKey.from_private_bytes(raw))
b = p.Identity(p.Ed25519PrivateKey.from_private_bytes(raw))
print(json.dumps({"dev": [r.DEV_CRYPTO, p.DEV_CRYPTO],
                  "ids": [a.peer_id, b.peer_id],
                  "sigs": [a.sign(b"m").hex(), b.sign(b"m").hex()]}))
"""


def test_dev_crypto_identities_equal_and_gated():
    raw = _rand_bytes(_rng(7), 32).hex()
    env = dict(os.environ, PYTHONPATH=ROOT, P2P_DEV_CRYPTO="1",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _DEV_IDS, raw], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["dev"] == [True, True]
    assert got["ids"][0] == got["ids"][1]
    assert got["sigs"][0] == got["sigs"][1]
    # The dev peer-id tag: never a real Ed25519 id.
    assert port_b58.b58decode(got["ids"][1])[:2] == b"\x01\xdd"
    # Without the opt-in the port fails loudly, as the reference does.
    env.pop("P2P_DEV_CRYPTO")
    out = subprocess.run([sys.executable, "-c", _DEV_IDS, raw], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode != 0 and "P2P_DEV_CRYPTO" in out.stderr


@pytest.mark.parametrize("seed", [0, 1])
def test_devcrypto_bytes_equal(seed):
    rng = _rng(seed)
    raw = _rand_bytes(rng, 32)
    ka = ref_dev.Ed25519PrivateKey.from_private_bytes(raw)
    kb = port_dev.Ed25519PrivateKey.from_private_bytes(raw)
    data = _rand_bytes(rng, 77)
    assert ka.sign(data) == kb.sign(data)
    assert ka.public_key().public_bytes() == kb.public_key().public_bytes()
    kb.public_key().verify(ka.sign(data), data)
    with pytest.raises(port_dev.InvalidSignature):
        kb.public_key().verify(ka.sign(data), data + b"!")
    # Key agreement on the same exponents.
    e1, e2 = (int(x) for x in rng.integers(2, 1 << 62, size=2))
    secrets = [mod.X25519PrivateKey(e1).exchange(
        mod.X25519PrivateKey(e2).public_key()) for mod in (ref_dev, port_dev)]
    assert secrets[0] == secrets[1]
    assert secrets[1] == port_dev.X25519PrivateKey(e2).exchange(
        port_dev.X25519PrivateKey(e1).public_key())
    # HKDF and the AEAD on the same key, nonce and data.
    salt, ikm = _rand_bytes(rng, 64), _rand_bytes(rng, 32)
    okm = [mod.HKDF(algorithm=None, length=64, salt=salt,
                    info=b"/p2p-llm-chat-tpu/secure/1.0.0").derive(ikm)
           for mod in (ref_dev, port_dev)]
    assert okm[0] == okm[1] and len(okm[0]) == 64
    key, nonce = okm[0][:32], (5).to_bytes(12, "little")
    msg = _rand_bytes(rng, 300)
    ct = [mod.ChaCha20Poly1305(key).encrypt(nonce, msg, None)
          for mod in (ref_dev, port_dev)]
    assert ct[0] == ct[1]
    assert port_dev.ChaCha20Poly1305(key).decrypt(nonce, ct[0], None) == msg
    bad = bytes([ct[0][0] ^ 1]) + ct[0][1:]
    with pytest.raises(port_dev.InvalidTag):
        port_dev.ChaCha20Poly1305(key).decrypt(nonce, bad, None)


def test_require_dev_crypto_gate(monkeypatch):
    monkeypatch.delenv("P2P_DEV_CRYPTO", raising=False)
    for mod in (ref_dev, port_dev):
        with pytest.raises(ImportError, match="P2P_DEV_CRYPTO"):
            mod.require_dev_crypto("identity")
    monkeypatch.setenv("P2P_DEV_CRYPTO", "1")
    port_dev.require_dev_crypto("identity")


def _pushes(rng, n=60):
    """A seeded push sequence with duplicates (redeliveries) and plain
    messages without a msg_id (the reference wire)."""
    out = []
    for i in range(n):
        r = float(rng.random())
        if out and r < 0.3:
            out.append(out[int(rng.integers(0, len(out)))])
        else:
            mid = "" if r > 0.9 else f"m{i}"
            out.append(dict(id=f"id{i}", from_user="a", to_user="b",
                            content=f"text {i}", timestamp="t",
                            msg_id=mid))
    return out


@pytest.mark.parametrize("cap", [None, 5, 1])
def test_inbox_listings_equal_under_duplicates(cap, monkeypatch):
    for mod in (ref_inbox, port_inbox):
        monkeypatch.setattr(mod, "_DEDUP_MAX", 16)
    assert port_inbox._DEDUP_PER_MSG == ref_inbox._DEDUP_PER_MSG == 8
    pushes = _pushes(_rng(0 if cap is None else cap), 80)
    boxes = (ref_inbox.Inbox(max_messages=cap),
             port_inbox.Inbox(max_messages=cap))
    for fields in pushes:
        fresh = [box.push(mod.ChatMessage(**fields)) for box, mod in
                 zip(boxes, (ref_proto, port_proto))]
        assert fresh[0] == fresh[1]
    assert len(boxes[0]) == len(boxes[1])
    for after in ("", "id3", "id40", "nope"):
        lists = [[m.to_dict() for m in box.drain(after)] for box in boxes]
        assert lists[0] == lists[1]
