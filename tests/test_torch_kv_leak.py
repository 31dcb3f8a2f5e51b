"""The KV tier gives back the pages of a session it drops as diverged.

An anonymous conversation's key is the hash of its prompt's first
``HEAD_GRAIN`` ids (serve/scheduler.py ``_session_key``), so requests
that share a long opening and then differ find each other's session by
key, see that its tokens are not a prefix of their prompt, and drop it
(serve/kv_tier.py ``KVTier.lookup``). The dropped session still holds
its resident pages. Here the port diverges from the reference on
purpose: the reference's ``lookup`` drops the session and loses those
pages (p2p_llm_chat_tpu/serve/kv_tier.py:321), so its pool shrinks by a
session's pages on every such request; the port's tier hands them to
the scheduler thread (``KVTier.released_pages``), which frees them. No
test compares the two packages' free-page counts after such requests:
they differ by design.

The invariant held after each request: every page but the reserved
page 0 is either free or held by a session the tier still lists.
"""

import pytest
import torch

from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.llama import init_params_quantized
from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                  GenerateRequest,
                                                  RequestStats)
from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
from p2p_llm_chat_tpu_torch.tokenizer import ByteTokenizer

torch.set_num_threads(2)
pytestmark = pytest.mark.model

CFG = get_config("tiny")
PAGES = 32
# 49 shared bytes, then each request its own continuation of growing
# length (so the sessions hold more pages as they go).
OPENING = "Shared opening of four anonymous conversations:: "
TAILS = ("one.", "the second one, a little longer.",
         "a third one, longer again, so that it needs one more page of KV "
         "than the last.",
         "and a fourth, the longest of all of them, which runs on and on "
         "past every earlier request so that its session holds the most "
         "pages of the four.")


def _quiet(sched) -> None:
    """Return once the loop has retained the finished request: a job
    runs at the start of a loop iteration, so the second of two jobs runs
    after the first's iteration released the row."""
    for _ in range(2):
        sched.run_on_loop(lambda: None)


def _held(tier) -> int:
    return sum(len(s.pages or ()) for s in tier.resident_sessions())


def test_diverged_anonymous_sessions_return_their_pages():
    assert len(OPENING) == 49
    params = init_params_quantized(CFG, seed=0, dtype=torch.float32,
                                   quant="", device="cpu")
    eng = TorchEngine(params, CFG, ByteTokenizer(CFG.vocab_size),
                      num_slots=2, max_seq=256, page_size=16,
                      num_pages=PAGES, prefix_cache=False, kv_quant=True,
                      kv_host_gb=1.0, kv_idle_s=1e9, kv_mode="paged",
                      device="cpu")
    try:
        sched = eng.scheduler
        sched.warmup((64, 128), eng.prefix_texts)
        tier = sched._tier
        free, held = [], []
        for tail in TAILS:
            req = GenerateRequest(
                prompt=OPENING + tail,
                options=GenerateOptions(max_tokens=8, temperature=0.0,
                                        seed=1))
            "".join(eng.generate_stream(req, RequestStats()))
            _quiet(sched)
            free.append(sched._alloc.free_pages)
            held.append(_held(tier))
            assert free[-1] + held[-1] == PAGES - 1, (free, held)
        # One session at a time: each request's key matched the last
        # one's session, found it diverged and dropped it.
        assert tier.counts() == (1, 0)
        assert tier.stats()["evicted_total"] == len(TAILS) - 1
        assert held[-1] > held[0]       # the sessions grew
        freed = sum(held[:-1])
        assert tier.stats()["pages_freed_total"] == freed
    finally:
        eng.stop()
