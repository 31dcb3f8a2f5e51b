"""The port's continuous-batching scheduler on the CPU (``tiny``, paged
int8 pool, int8 weights): stop strings, streaming, context continuation,
the bounded queue, cancellation and the context budget.

The weights are the reference's quote-workload weights
(models/synth.quote_params) carried across with params_from_numpy: their
greedy output is printable ASCII, so text-level behaviour (stop strings,
incremental detokenisation) has text to act on.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  OverloadError,
                                                  RequestStats, collect)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model


@pytest.fixture(scope="module")
def params():
    tree = quote_params(ref_config("tiny"), jax.random.PRNGKey(5),
                        quantized=True)
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _engine(params, **kw) -> TorchEngine:
    cfg = get_config("tiny")
    args = dict(num_slots=2, max_seq=64, page_size=16, kv_quant=True,
                kv_mode="paged", device="cpu")
    args.update(kw)
    return TorchEngine(params, cfg, ByteTokenizer(cfg.vocab_size), **args)


def _req(prompt: str, **opts) -> GenerateRequest:
    return GenerateRequest(prompt=prompt, options=GenerateOptions(**opts))


def _wait_pool_drained(engine: TorchEngine) -> dict:
    deadline = time.monotonic() + 30
    while True:
        snap = engine.metrics_snapshot()
        if (snap["serve_kv_free_pages"] == snap["serve_kv_total_pages"]
                and snap["serve_batch_occupancy"] == 0):
            return snap
        assert time.monotonic() < deadline, snap
        time.sleep(0.01)


def test_stop_string_and_stream_match_plain_output(params):
    engine = _engine(params)
    try:
        stats = RequestStats()
        text = collect(engine, _req("hello", max_tokens=24), stats)
        assert stats.completion_tokens == 24 and len(text) == 24
        assert text.isprintable()
        deltas = list(engine.generate_stream(_req("hello", max_tokens=24)))
        assert "".join(deltas) == text and len(deltas) >= 1
        stop = text[5:8]
        cut = text.find(stop)
        stats = RequestStats()
        got = collect(engine, _req("hello", max_tokens=24, stop=(stop,)),
                      stats)
        assert got == text[:cut]
        assert stats.completion_tokens < 24
        _wait_pool_drained(engine)
    finally:
        engine.stop()


def test_context_continuation_prepends_ids_without_a_second_bos(params):
    engine = _engine(params)
    try:
        first = RequestStats()
        collect(engine, _req("ab", max_tokens=4), first)
        assert first.context[:3] == [256, ord("a"), ord("b")]
        second = RequestStats()
        collect(engine, GenerateRequest(
            prompt="cd", context=tuple(first.context),
            options=GenerateOptions(max_tokens=3)), second)
        n = len(first.context)
        assert second.context[:n + 2] == first.context + [ord("c"), ord("d")]
        assert second.prompt_tokens == n + 2
    finally:
        engine.stop()


def test_bounded_queue_sheds_at_submit(params):
    engine = _engine(params, num_slots=1, queue_max=1)
    hold = threading.Event()
    # Occupy the scheduler thread so submitted requests stay queued.
    engine.scheduler.post_on_loop(hold.wait)
    try:
        kept = engine.generate_stream(_req("x", max_tokens=2))
        with pytest.raises(OverloadError):
            engine.generate_stream(_req("y", max_tokens=2))
        assert engine.metrics_snapshot()["requests_shed_total"] == 1
        hold.set()
        assert len("".join(kept)) <= 2
        engine.generate_stream(_req("z", max_tokens=1)).close()
    finally:
        hold.set()
        engine.stop()


def test_drain_sheds_new_work_and_turns_not_ready(params):
    engine = _engine(params)
    try:
        assert engine.ready()
        engine.drain()
        assert not engine.ready()
        with pytest.raises(OverloadError, match="draining"):
            engine.generate_stream(_req("x", max_tokens=2))
    finally:
        engine.stop()


def test_failed_warmup_is_kept_and_never_ready(params, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("kernel build failed")

    engine = _engine(params)
    monkeypatch.setattr("p2p_llm_chat_tpu_torch.models.llama.prefill", boom)
    try:
        engine.warmup((16,))
        deadline = time.monotonic() + 30
        while engine.warmup_error is None:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert "kernel build failed" in str(engine.warmup_error)
        assert not engine.ready()
    finally:
        engine.stop()


def test_closed_stream_cancels_and_frees_its_pages(params):
    engine = _engine(params)
    try:
        stream = engine.generate_stream(_req("long", max_tokens=40))
        next(stream)
        stream.close()
        snap = _wait_pool_drained(engine)
        assert snap["serve_admitted_total"] == 1
    finally:
        engine.stop()


def test_num_predict_zero_runs_to_the_context_budget(params):
    engine = _engine(params, max_seq=32)
    try:
        stats = RequestStats()
        collect(engine, _req("hi", max_tokens=0), stats)
        # BOS + 2 bytes in a 32-slot context: room for the rest, minus the
        # reserved next-write slot.
        assert stats.prompt_tokens == 3
        assert 0 < stats.completion_tokens <= 32 - 1 - 3
        assert len(stats.context) == 3 + stats.completion_tokens
        _wait_pool_drained(engine)
    finally:
        engine.stop()
