"""Session and prefix wire formats and live session migration, the port
against the reference, on the CPU.

- Session wire (serve/kv_tier.py): a payload the port serializes is read
  by the reference's ``deserialize_session`` and the reverse, for int8
  pools (values and head-major scales), bf16 pools (raw 2-byte words
  under the name ``"bfloat16"``, read here through ``ml_dtypes``; the
  port itself needs no ``ml_dtypes``), f32 pools and dense rows: every
  array bitwise equal, the key, tokens, length and span equal. Untrusted
  payloads reject, never raise.
- Prefix wire (serve/prefix.py): an entry exported by either store
  imports into the other with the same ids, dtype and k/v (bf16 -> f32 ->
  bf16 is lossless: bitwise).
- The tier's migration semantics (export retains, adopt refuses a
  resident copy and replaces a parked one, forget is not an eviction)
  and the ``serve.kv_tier.export`` / ``serve.kv_tier.import`` failpoints
  (the session survives; a failed import installs nothing).
- Park on port engine A, export, import on port engine B, resume on B:
  byte-identical to the conversation resumed on B having never moved,
  for an explicit session id and for the anonymous head index; a stale
  re-import over a resident copy and incompatible payloads reject.
- Across the stacks on the quote weights (tiny; the int8 pool at page
  size 64, and the dense cache): a JAX engine's exported session wakes on
  the port with the JAX engine's own wake stream, and a port export wakes
  on a JAX engine with the port's.
"""

import io
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import llama as ref_llama
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu.serve import kv_tier as ref_tier
from p2p_llm_chat_tpu.serve import prefix as ref_prefix
from p2p_llm_chat_tpu.serve.backend import (GenerateOptions as RefOptions,
                                            GenerateRequest as RefRequest,
                                            RequestStats as RefStats)
from p2p_llm_chat_tpu.serve.engine import TPUEngine
from p2p_llm_chat_tpu.tokenizer import ByteTokenizer as RefByteTokenizer
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import (params_from_numpy,
                                                   tensor_from_numpy)
from p2p_llm_chat_tpu_torch.serve import kv_tier
from p2p_llm_chat_tpu_torch.serve import prefix
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.serve.scheduler import BatchScheduler
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer
from p2p_llm_chat_tpu_torch.utils import failpoints

torch.set_num_threads(2)
pytestmark = pytest.mark.model

RCFG = ref_config("tiny")
CFG = get_config("tiny")
PROMPT1 = "hello there, how are you doing today my good friend?"
PROMPT2 = " tell me one more thing before we finish?"
ANON = "an entirely anonymous conversation opener, long enough to index!"


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _t_bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def _payload(kind: str, seed: int = 0) -> tuple:
    """Random arrays of a pool kind as numpy (reference side) and torch
    (port side) twins, and the span."""
    rng = np.random.default_rng(seed)
    L, P, ps, Hkv, D = 2, 4, 8, 2, 6
    if kind == "int8":
        k = rng.integers(-127, 128, size=(L, P, ps, Hkv, D), dtype=np.int8)
        v = rng.integers(-127, 128, size=(L, P, ps, Hkv, D), dtype=np.int8)
        ks = rng.random((L, P, Hkv, 128), dtype=np.float32)
        vs = rng.random((L, P, Hkv, 128), dtype=np.float32)
        arrays, span = (k, v, ks, vs), 3
    elif kind == "bf16":
        w = rng.integers(0, 2 ** 16, size=(2, L, P, ps, Hkv, D),
                         dtype=np.uint16) & 0xBFFF
        arrays, span = (w[0].view(ml_dtypes.bfloat16),
                        w[1].view(ml_dtypes.bfloat16), None, None), 4
    elif kind == "f32":
        arrays, span = (rng.standard_normal((L, P, ps, Hkv, D),
                                            dtype=np.float32),
                        rng.standard_normal((L, P, ps, Hkv, D),
                                            dtype=np.float32),
                        None, None), 2
    else:                              # a dense row: ((k, v), width)
        arrays, span = (rng.standard_normal((L, 64, Hkv, D),
                                            dtype=np.float32),
                        rng.standard_normal((L, 64, Hkv, D),
                                            dtype=np.float32)), 64
    twins = tuple(None if a is None else tensor_from_numpy(a, device="cpu")
                  for a in arrays)
    return arrays, twins, span


KINDS = ["int8", "bf16", "f32", "dense"]


@pytest.mark.parametrize("kind", KINDS)
def test_session_wire_port_to_reference(kind):
    arrays, twins, span = _payload(kind)
    sess = kv_tier.SessionKV(
        key=f"sid:{kind}", tokens=tuple(range(40)), length=39,
        host=(twins, span),
        nbytes=sum(kv_tier.tensor_nbytes(t) for t in twins))
    got = ref_tier.deserialize_session(kv_tier.serialize_session(sess))
    assert got is not None
    assert (got.key, got.tokens, got.length, got.host[1]) == (
        sess.key, sess.tokens, 39, span)
    assert got.nbytes == sess.nbytes
    assert len(got.host[0]) == len(arrays)
    for a, b in zip(arrays, got.host[0]):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(_np_bits(b), _np_bits(a))


@pytest.mark.parametrize("kind", KINDS)
def test_session_wire_reference_to_port(kind):
    arrays, twins, span = _payload(kind, seed=1)
    sess = ref_tier.SessionKV(
        key=f"head:{kind}", tokens=tuple(range(50)), length=50,
        host=(arrays, span),
        nbytes=sum(a.nbytes for a in arrays if a is not None))
    got = kv_tier.deserialize_session(ref_tier.serialize_session(sess))
    assert got is not None
    assert (got.key, got.tokens, got.length, got.host[1]) == (
        sess.key, sess.tokens, 50, span)
    assert got.nbytes == sess.nbytes and got.parked
    for t, b in zip(twins, got.host[0]):
        assert (t is None) == (b is None)
        if t is not None:
            assert b.dtype == t.dtype and b.shape == t.shape
            np.testing.assert_array_equal(_t_bits(b), _t_bits(t))


def test_session_export_is_stored_not_deflated():
    """The port's session payload is an npz whose members are stored: the
    deflate of a dense llama3.1-8b session (268 MB) outlasts a peer's
    30 s pull; the reference reads the stored form bitwise."""
    import zipfile
    arrays, twins, span = _payload("dense")
    sess = kv_tier.SessionKV(key="sid:st", tokens=tuple(range(40)),
                             length=40, host=(twins, span), nbytes=1)
    data = kv_tier.serialize_session(sess)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        assert {i.compress_type for i in z.infolist()} == {
            zipfile.ZIP_STORED}
    got = ref_tier.deserialize_session(data)
    for a, b in zip(arrays, got.host[0]):
        np.testing.assert_array_equal(_np_bits(b), _np_bits(a))


@pytest.mark.parametrize("data", [
    b"", b"garbage bytes, not an npz", "truncated", "other-version",
    "zero-length"], ids=["empty", "garbage", "truncated", "version",
                         "length"])
def test_untrusted_session_payloads_reject(data):
    _, twins, span = _payload("int8")
    good = kv_tier.SessionKV(key="sid:a", tokens=tuple(range(40)), length=40,
                             host=(twins, span), nbytes=1)
    wire = kv_tier.serialize_session(good)
    if data == "truncated":
        data = wire[:40]
    elif data in ("other-version", "zero-length"):
        with np.load(io.BytesIO(wire)) as z:
            fields = {k: z[k] for k in z.files}
        if data == "other-version":
            fields["version"] = np.int64(2)
        else:
            fields["length"] = np.int64(0)
        buf = io.BytesIO()
        np.savez_compressed(buf, **fields)
        data = buf.getvalue()
    assert kv_tier.deserialize_session(data) is None
    assert ref_tier.deserialize_session(data) is None


def test_tier_export_retains_adopt_and_forget():
    tier = kv_tier.KVTier(host_bytes=1 << 20)
    arr = torch.zeros((2, 2, 4, 4), dtype=torch.int8)
    tier.insert(kv_tier.SessionKV(key="sid:p", tokens=tuple(range(40)),
                                  length=40, host=((arr, arr, None, None), 1),
                                  nbytes=2 * arr.numel()))
    data = tier.export_payload("sid:p")
    assert data is not None and "sid:p" in tier.sessions_meta()
    tier.insert(kv_tier.SessionKV(key="sid:r", tokens=tuple(range(40)),
                                  length=40, pages=[1, 2]))
    assert tier.export_payload("sid:r") is None       # resident: park first
    assert tier.export_payload("sid:absent") is None
    stale = kv_tier.deserialize_session(data)
    stale.key = "sid:r"
    assert tier.adopt(stale) is False                 # resident is fresher
    repl = kv_tier.deserialize_session(data)
    assert tier.adopt(repl) is True
    assert tier.stats()["host_bytes"] == repl.nbytes
    assert tier.forget("sid:r") is False
    assert tier.forget("sid:p") is True
    assert tier.forget("sid:p") is False
    assert tier.stats()["evicted_total"] == 0
    assert set(tier.sessions_meta()) == {"sid:r"}


def test_export_failpoint_raises_and_session_survives():
    tier = kv_tier.KVTier(host_bytes=1 << 20)
    arr = torch.zeros(8, dtype=torch.int8)
    tier.insert(kv_tier.SessionKV(key="sid:x", tokens=tuple(range(40)),
                                  length=40, host=((arr, arr, None, None), 1),
                                  nbytes=16))
    failpoints.arm("serve.kv_tier.export", "raise")
    try:
        with pytest.raises(failpoints.FailpointError):
            tier.export_payload("sid:x")
    finally:
        failpoints.disarm_all()
    assert "sid:x" in tier.sessions_meta()
    assert tier.export_payload("sid:x") is not None


def test_import_failpoint_raises_and_tier_untouched():
    """Armed, the fault fires before the payload is parsed or adopted;
    disarmed, the same call rejects a malformed payload."""

    class _Stub:
        _tier = kv_tier.KVTier(host_bytes=1 << 20)

    stub = _Stub()
    failpoints.arm("serve.kv_tier.import", "raise")
    try:
        with pytest.raises(failpoints.FailpointError):
            BatchScheduler.session_import(stub, b"whatever")
    finally:
        failpoints.disarm_all()
    assert stub._tier.sessions_meta() == {}
    assert BatchScheduler.session_import(stub, b"not a payload") is None


# -- prefix wire ------------------------------------------------------------------

def _entry_pair(dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = tuple(int(t) for t in rng.integers(0, 300, size=24))
    k = rng.standard_normal((2, 24, 2, 8), dtype=np.float32)
    v = rng.standard_normal((2, 24, 2, 8), dtype=np.float32)
    if dtype == "bfloat16":
        k = k.astype(ml_dtypes.bfloat16)
        v = v.astype(ml_dtypes.bfloat16)
    ref_e = ref_prefix.PrefixEntry(ids=ids, k=jnp.asarray(k),
                                   v=jnp.asarray(v))
    port_e = prefix.PrefixEntry(ids=ids,
                                k=tensor_from_numpy(k, device="cpu"),
                                v=tensor_from_numpy(v, device="cpu"))
    return ref_e, port_e, (k, v)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefix_wire_both_ways(dtype):
    ref_e, port_e, (k, v) = _entry_pair(dtype)
    ref_store, port_store = ref_prefix.PrefixStore(), prefix.PrefixStore()
    ref_store.put(ref_e)
    port_store.put(port_e)
    assert port_store.hashes() == ref_store.hashes()
    h = port_e.token_hash
    # port -> reference
    got = ref_prefix.PrefixStore().import_payload(port_store.export_payload(h))
    assert got is not None and got.ids == ref_e.ids
    assert str(got.k.dtype) == dtype
    np.testing.assert_array_equal(_np_bits(got.k), _np_bits(k))
    np.testing.assert_array_equal(_np_bits(got.v), _np_bits(v))
    # reference -> port
    store = prefix.PrefixStore()
    got = store.import_payload(ref_store.export_payload(h), device="cpu")
    assert got is not None and got.ids == port_e.ids
    assert got.k.dtype == port_e.k.dtype
    np.testing.assert_array_equal(_t_bits(got.k), _t_bits(port_e.k))
    np.testing.assert_array_equal(_t_bits(got.v), _t_bits(port_e.v))
    assert store.hashes() == {h: {"len": 24, "hits": 0}}
    assert port_store.export_payload("absent") is None
    assert store.import_payload(b"not an npz") is None
    # An engine passes its (layers, kv heads, head dim): another model's
    # entry is refused before it is stored.
    other = prefix.PrefixStore()
    wire = ref_store.export_payload(h)
    assert other.import_payload(wire, geometry=(3, 2, 8)) is None
    assert len(other) == 0
    assert other.import_payload(wire, geometry=(2, 2, 8)) is not None


def test_prefix_export_is_stored_not_deflated():
    """The port's prefix payload is an npz whose members are stored: the
    deflate of a llama3.1-8b-sized entry outlasts a peer's 30 s pull;
    the reference reads the stored form."""
    import zipfile
    _, port_e, (k, _) = _entry_pair("bfloat16")
    store = prefix.PrefixStore()
    store.put(port_e)
    data = store.export_payload(port_e.token_hash)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        assert {i.compress_type for i in z.infolist()} == {
            zipfile.ZIP_STORED}
    got = ref_prefix.PrefixStore().import_payload(data)
    np.testing.assert_array_equal(_np_bits(got.k), _np_bits(k))


# -- engines -----------------------------------------------------------------------

def run(engine, prompt, session="", max_tokens=8, ctx=()):
    stats = RequestStats()
    req = GenerateRequest(prompt=prompt, session=session, context=tuple(ctx),
                          options=GenerateOptions(max_tokens=max_tokens,
                                                  temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


def _ref_run(engine, prompt, session="", max_tokens=8, ctx=()):
    stats = RefStats()
    req = RefRequest(prompt=prompt, session=session, context=tuple(ctx),
                     options=RefOptions(max_tokens=max_tokens,
                                        temperature=0.0, seed=1))
    return "".join(engine.generate_stream(req, stats)), stats


ENGINE_KW = dict(num_slots=2, max_seq=256, page_size=64, kv_quant=True,
                 kv_host_gb=1.0, kv_idle_s=1e9)


def make_engine(params):
    eng = TorchEngine(params, CFG, ByteTokenizer(CFG.vocab_size),
                      prefix_cache=False, kv_mode="paged",
                      device="cpu", **ENGINE_KW)
    eng.scheduler.warmup((64, 128))
    return eng


def wait_for(fn, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def park(eng, key: str) -> None:
    """Park one session through the loop's handshake (as an export
    would) and wait until it is parked."""
    eng.scheduler.park_all(key=key)
    wait_for(lambda: eng.scheduler._tier.sessions_meta().get(
        key, {}).get("parked", False), msg=f"park of {key}")


@pytest.fixture(scope="module")
def params():
    rparams = ref_llama.init_params(RCFG, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, rparams),
                             device="cpu")


def test_cross_engine_migration_byte_identity(params):
    a, b = make_engine(params), make_engine(params)
    try:
        o1, os_ = run(b, PROMPT1, "oracle")
        o2, _ = run(b, PROMPT2, "oracle", ctx=os_.context)
        assert b.scheduler.metrics_snapshot()["kv_waked_total"] == 1

        a1, s1 = run(a, PROMPT1, "m")
        assert a1 == o1
        wait_for(lambda: "sid:m" in a.scheduler._tier.sessions_meta(),
                 msg="turn-1 retention on A")
        payload = a.session_export("sid:m")       # parks it first
        assert payload is not None
        assert a.scheduler._tier.sessions_meta()["sid:m"]["parked"]
        adopted = b.session_import(payload)
        assert adopted is not None and adopted.key == "sid:m"
        m2, _ = run(b, PROMPT2, "m", ctx=s1.context)
        assert m2 == o2, "migrated resume diverged from never-migrated"
        snap = b.scheduler.metrics_snapshot()
        assert snap["kv_waked_total"] == 2
        assert snap["kv_wake_cold_total"] == 1
        assert a.session_forget("sid:m") is True
        assert "sid:m" not in a.scheduler._tier.sessions_meta()

        # The anonymous head index migrates with the session.
        _, ds = run(a, ANON, "")
        wait_for(lambda: any(k.startswith("head:")
                             for k in a.scheduler._tier.sessions_meta()),
                 msg="anonymous retention on A")
        key = next(k for k in a.scheduler._tier.sessions_meta()
                   if k.startswith("head:"))
        park(a, key)
        adopted = b.session_import(a.session_export(key))
        assert adopted is not None and adopted.key == key
        run(b, PROMPT2, "", ctx=ds.context)
        assert b.scheduler.metrics_snapshot()["kv_waked_total"] == 3

        # A resident local copy refuses a stale re-import.
        wait_for(lambda: not b.scheduler._tier.sessions_meta()
                 .get("sid:m", {"parked": True})["parked"],
                 msg="turn-2 re-retention on B")
        assert b.session_import(payload) is None

        # Incompatible payloads reject without touching the tier.
        wait_for(lambda: b.scheduler.metrics_snapshot()
                 ["kv_open_sessions"] == 3, msg="retentions settled on B")
        assert b.session_import(b"not a payload") is None
        ks = torch.zeros((CFG.num_layers, 64, CFG.num_kv_heads,
                          CFG.head_dim))
        dense = kv_tier.SessionKV(key="sid:d", tokens=tuple(range(40)),
                                  length=40, host=((ks, ks), 64), nbytes=1)
        assert b.session_import(kv_tier.serialize_session(dense)) is None
        bad = torch.zeros((CFG.num_layers, 2, 16, 8), dtype=torch.int8)
        sc = torch.zeros((CFG.num_layers, 2, 16))
        wrong = kv_tier.SessionKV(key="sid:w", tokens=tuple(range(40)),
                                  length=40, host=((bad, bad, sc, sc), 1),
                                  nbytes=1)
        assert b.session_import(kv_tier.serialize_session(wrong)) is None
        assert b.scheduler.metrics_snapshot()["kv_open_sessions"] == 3
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_cross_stack_migration_byte_identity(kv_mode):
    """Quote weights: the JAX engine parks and exports turn 1; the port
    imports it and wakes turn 2 with the JAX engine's own turn-2 stream.
    Then the reverse: the port exports, the JAX engine wakes with the
    port's stream. Over the int8 pool (kind "paged") and over the dense
    cache (kind "dense": a bf16 row, parked at finish)."""
    rparams = quote_params(RCFG, jax.random.PRNGKey(3), quantized=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, rparams),
                                device="cpu")
    kw = dict(ENGINE_KW, kv_quant=kv_mode == "paged")
    ref = TPUEngine(rparams, RCFG, RefByteTokenizer(RCFG.vocab_size),
                    kv_mode=kv_mode, prefix_cache=False, **kw)
    port = TorchEngine(tparams, CFG, ByteTokenizer(CFG.vocab_size),
                       prefix_cache=False, kv_mode=kv_mode,
                       device="cpu", **kw)
    try:
        for eng in (ref, port):
            eng.warmup(buckets=(64, 128))
        for eng in (ref, port):
            wait_for(eng.ready, timeout=300, msg="warmup")
        go = {"ref": (ref, _ref_run), "port": (port, run)}
        for src, dst in (("ref", "port"), ("port", "ref")):
            (se, srun), (de, drun) = go[src], go[dst]
            sid = f"x-{src}"
            t1, s1 = srun(se, "abcabc hello hello", sid, max_tokens=12)
            wait_for(lambda: f"sid:{sid}" in se.session_list(),
                     msg="retention")
            payload = se.session_export(f"sid:{sid}")
            assert payload is not None
            assert kv_tier.deserialize_session(payload).parked
            with np.load(io.BytesIO(payload)) as z:
                assert z["kind"].tobytes().decode() == kv_mode
            # The source's own wake of the same turn is the oracle.
            want, ws = srun(se, " and again", sid, ctx=s1.context,
                            max_tokens=12)
            assert de.session_import(payload) is not None
            waked = de.scheduler.metrics_snapshot()["kv_waked_total"]
            got, gs = drun(de, " and again", sid, ctx=s1.context,
                           max_tokens=12)
            assert gs.context == ws.context, (src, dst)
            assert (de.scheduler.metrics_snapshot()["kv_waked_total"]
                    == waked + 1), f"{dst} did not wake the {src} payload"
    finally:
        ref.stop()
        port.stop()
