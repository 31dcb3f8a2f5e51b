"""The seeded traffic: deterministic, the same work under every seed, and
the reference's shapes."""

from __future__ import annotations

import itertools
import json

from p2p_llm_chat_tpu_torch.serve.engine import SUGGEST_PREFIX
from perfbench import traffic as gen

from .conftest import REPO


def mix() -> dict:
    return json.loads((REPO / "perfbench/traffic/copilot_mix.json").read_text())


def closed() -> dict:
    return json.loads(
        (REPO / "perfbench/traffic/copilot_closed32.json").read_text())


def test_the_schedule_is_a_function_of_the_seed():
    big = 2 ** 31 + 987654321
    a = gen.open_schedule(mix(), big, [10, 60])
    assert a == gen.open_schedule(mix(), big, [10, 60])
    b = gen.open_schedule(mix(), big + 1, [10, 60])
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_every_seed_gets_the_same_window_in_another_order():
    lead, window = 10, 51

    def work(s):
        rs = [r for r in gen.open_schedule(mix(), s, [lead, window, 60])
              if lead <= r.due_s < lead + window]
        gaps = [round(y.due_s - x.due_s, 9) for x, y in zip(rs, rs[1:])]
        return (sorted((r.cls, len(r.prompt)) for r in rs),
                sorted((r.cls, r.max_tokens) for r in rs),
                sorted(gaps), len(rs))
    a, b = work(1), work(3_000_000_007)
    assert a[:2] == b[:2] and a[3] == b[3]
    assert a[3] == round(mix()["rate_rps"] * window)
    # The gaps are one set scaled to fill the window: the same up to the
    # scale and the two gaps cut at its ends.
    assert abs(sum(a[2]) - sum(b[2])) < window / 4


def test_the_mix_keeps_the_reference_shapes():
    rs = gen.open_schedule(mix(), 5, [120])
    sug = [r for r in rs if r.cls == "suggestion"]
    long = [r for r in rs if r.cls == "long"]
    assert len(sug) == 4 * len(long)
    for r in sug:
        assert r.ttft and r.prompt.startswith(SUGGEST_PREFIX)
        assert r.prompt.endswith("\n\nReply:")
        msg = r.prompt[len(SUGGEST_PREFIX):-len("\n\nReply:")]
        assert 16 <= len(msg) <= 256 and 16 <= r.max_tokens <= 128
    for r in long:
        assert not r.ttft and 2048 <= 1 + len(r.prompt) <= 3584
        assert 16 <= r.max_tokens <= 64
    heads = [r.prompt[len(SUGGEST_PREFIX):len(SUGGEST_PREFIX) + 10]
             for r in sug]
    assert len(set(heads)) == len(heads)          # a unique head each
    assert all(32 <= ord(c) < 127 or c == "\n" for r in rs for c in r.prompt)


def test_the_closed_loop_stream_is_seeded_and_endless():
    a = list(itertools.islice(gen.closed_stream(closed(), 9), 600))
    b = list(itertools.islice(gen.closed_stream(closed(), 9), 600))
    assert a == b and len({r.index for r in a}) == 600
    assert {r.cls for r in a} == {"suggestion"}
