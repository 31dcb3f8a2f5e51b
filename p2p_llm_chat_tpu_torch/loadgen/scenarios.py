"""Loadgen scenario registry: what traffic looks like, and what it owes.

Each :class:`Scenario` bundles a mix weight, a payload builder that
emits the concrete HTTP steps for one arrival (against the real wire
paths — UI ``/api/suggest/stream``, node ``/send``, serve
``/api/generate|chat|embed``), and the per-scenario SLO the ledger
(report.py) judges the run against.

The registered scenarios (the reference's, name for name, weight for
weight and SLO for SLO):

=============== ==========================================================
``short_chat``  one chat turn end-to-end: peer i's node delivers a short
                message to peer i+1 over the encrypted P2P stream, then
                the recipient's UI fires the co-pilot suggestion (the
                exact browser path, NDJSON streamed). Falls back to a
                serve-level ``/api/chat`` turn when the run has no
                chat plane (stub mode).
``long_ctx``    a ~3k-token prompt through ``/api/generate`` — the
                prefill-pressure case chunked prefill exists for.
``embed``       ``/api/embed`` — the non-generative endpoint class
                (bypasses the decode scheduler; latency = full answer).
``unbounded``   ``num_predict: -1`` (Ollama "until EOS / context
                full") with a per-request ``num_ctx`` cap — the
                worst-case stream length class.
``park_wake``   two ``/api/generate`` turns under one ``X-Session-Id``
                with a think-time pause between them: the follow-up
                extends the first prompt, so engines with the KV tier
                (serve/kv_tier.py) wake the parked session instead of
                re-prefilling. The SLO is judged on the follow-up turn.
``churn``       a THREE-turn session whose think-time pauses span
                whatever fleet churn the run arms (a replica draining
                and undraining — or dying and respawning — via
                chaos.ChurnWindow): with live session migration
                (serve/router.py) every turn still completes
                and the judged final-turn TTFT stays bounded — the
                zero-session-loss scenario. Degrades to plain
                multi-turn traffic on a static fleet.
``slow_reader`` the adversarial client class: an NDJSON stream read at
                a near-zero rate (TCP backpressure holds the server's
                writer), and roughly half the arrivals DISCONNECTING
                mid-stream — the disconnect storm. The server-side
                contract (inflight gauges settle to 0, no leaked decode
                slots — the stream-close discipline) is asserted by the
                chaos/test layer; the ledger judges only that the
                streams the client kept were serviced.
``group_chat``  the thundering herd: ONE inbound node message fans out
                N concurrent co-pilot suggest streams with identical
                content (the group-chat shape the prefill pool and the
                prefix cache exist for). Judged as one unit — TTFT is
                the WORST first delta across the fan; any failed member
                fails the record. Serve-only runs fan N identical
                ``/api/chat`` streams instead.
``relay_path``  the NAT-blocked pair: one node ``/send`` between the
                ring's most DISTANT peers, judged on the /send round
                trip itself. On fleets that blocklist the pair's direct
                dials the delivery rides the relay splice (the request's
                ``node.send`` trace span records ``via=relay``); on an
                open fleet the same send goes direct — either way the
                P2P delivery leg gets its own SLO instead of hiding
                inside short_chat's unmeasured first step. Serve-only
                runs degrade to a short ``/api/chat`` turn.
``peer_churn``  the chat plane under peer death: one node ``/send``
                to the ring neighbour, judged on the /send round trip,
                flown while a NodeChurnWindow (chaos.py) kills and
                restarts real nodes mid-run. While the recipient is
                down the sender answers a well-formed
                ``{"status":"queued"}`` 200 fast — the at-least-once
                outbox absorbed it — so the judged latency stays
                bounded THROUGH the kill; actual delivery rides the
                redelivery worker once the peer returns, and the
                zero-loss / zero-duplicate oracle is asserted by the
                chaos/test layer over recipient inboxes
                (chaos.check_churn_delivery), not by this record.
``multi_model``  the heterogeneous fleet: one arrival
                stream split across the run's two ``SERVE_MODELS``
                tags — most arrivals hit the interactive default
                model, the rest the large-MoE trunk.
                ``LOADGEN_MODELS=tagA,tagB`` names the tags (resolved
                at build time); each measured step is phase-tagged
                ``model_a``/``model_b`` so the ledger judges the two
                latency classes separately instead of blending a 7B
                TTFT with a 47B-class one. With ``LOADGEN_MODELS``
                unset the steps carry no ``model`` field — plain
                single-model traffic, still judgeable.
``disagg_session`` a two-turn session whose turns ride the
                prefill→decode handoff on a disaggregated fleet
                (serve/disagg.py): turn 1 is a NEW
                conversation (chunk-prefill on the prefill pool +
                handoff; ``phase="prefill"``), turn 2 extends it after
                think time (a verify-shaped wake on the decode replica;
                ``phase="decode"``, the judged step). Per-phase SLOs
                attribute a miss to the right pool. Plain two-turn
                session traffic on an undisaggregated fleet.
=============== ==========================================================

SLO targets default to the CPU dev-profile numbers (this is the profile
the 64–128-peer chat-plane runs use in CI-class containers; a 2-core
host serving 64 peers is *supposed* to be slow). ``LOADGEN_SLO_SCALE``
multiplies every latency target — TPU operating points run with a
fraction, e.g. ``LOADGEN_SLO_SCALE=0.05``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.env import env_float, env_or

__all__ = [
    "SLO", "Step", "Scenario", "Endpoints", "REGISTRY",
    "default_mix", "parse_mix", "slo_scale",
]


@dataclass(frozen=True)
class SLO:
    """Per-scenario service-level objectives. Latency fields are
    milliseconds and pre-scaled by :func:`slo_scale` at judgement time;
    ``itl_p95_ms`` is None for non-streaming scenarios (no inter-token
    gap exists)."""

    ttft_p50_ms: float
    ttft_p95_ms: float
    itl_p95_ms: Optional[float]
    max_shed_frac: float


@dataclass(frozen=True)
class Step:
    """One HTTP call of a scenario plan. ``measured`` marks the step the
    SLO is judged on (exactly one per plan); non-measured steps still
    fail the record on error. ``stream`` selects NDJSON reading; the
    delta text is found under ``delta``/``response``/``message.content``
    whichever the endpoint speaks."""

    url: str
    payload: dict
    stream: bool = False
    measured: bool = False
    session: str = ""
    pause_before_s: float = 0.0
    # Adversarial-client knobs (the slow_reader scenario): sleep this
    # long after every consumed NDJSON line (a near-zero read rate —
    # TCP backpressure holds the server's writer), and deliberately
    # DISCONNECT after this many deltas (0 = read to completion). An
    # abort is the client's choice, recorded ok — the server-side
    # contract (inflight gauges settle) is asserted elsewhere.
    read_delay_s: float = 0.0
    abort_after_deltas: int = 0
    # Thundering herd (group_chat): issue this many IDENTICAL streams
    # concurrently for this one step; the herd is judged as one unit
    # (worst TTFT across the fan). 0/1 = a plain single request.
    fanout: int = 0
    # Phase attribution (disagg_session): tag this step's first-delta
    # latency under a named phase so the ledger can split SLO misses
    # by prefill vs decode (report.py judges Scenario.phase_slos).
    phase: str = ""
    # Ollama stateless-continuation round trip: ``carry_context``
    # stashes this step's final-record ``context`` ids;
    # ``use_context`` injects the stashed ids into this step's payload
    # — the real-client turn shape, and the ONLY shape whose follow-up
    # can WAKE a parked/migrated session (the KV tier matches on the
    # token ids the context carries, not on re-sent text).
    carry_context: bool = False
    use_context: bool = False


@dataclass(frozen=True)
class Endpoints:
    """Where the driver aims. ``node_urls``/``ui_urls`` empty = no chat
    plane in this run (stub / serve-only); scenarios degrade to their
    serve-level equivalent. ``users`` aligns with ``node_urls`` —
    ``users[i]`` is the username registered by node i."""

    serve_url: str
    ui_urls: tuple = ()
    node_urls: tuple = ()
    users: tuple = ()


@dataclass(frozen=True)
class Scenario:
    name: str
    weight: float
    slo: SLO
    build: Callable[[random.Random, int, Endpoints], list] = field(repr=False)
    # Optional per-phase SLOs keyed by Step.phase (disagg_session):
    # judged IN ADDITION to the scenario SLO, so a miss names the
    # serving phase — prefill-pool admission vs decode-side wake —
    # instead of one blended number.
    phase_slos: Optional[dict] = None


def slo_scale() -> float:
    return env_float("LOADGEN_SLO_SCALE", 1.0)


# ---------------------------------------------------------------------------
# payload builders
# ---------------------------------------------------------------------------

_FILLER = ("Earlier in this thread we discussed the quarterly plans, "
           "the picnic schedule, and who brings which dish. ")


def _chat_text(rng: random.Random, to: str) -> str:
    # Unique head per request: identical heads would trip prefix
    # auto-promotion builds mid-run (a compile stall the e2e bench
    # learned to avoid) and would collapse router affinity onto one
    # home replica.
    return (f"[{rng.getrandbits(32):08x}] Hey {to}, are we still meeting "
            f"tomorrow at {8 + rng.randrange(9)}:{15 * rng.randrange(4):02d}?")


def _build_short_chat(rng: random.Random, peer: int,
                      ep: Endpoints) -> list:
    if ep.node_urls and ep.ui_urls:
        n = len(ep.node_urls)
        to = (peer + 1) % n
        msg = _chat_text(rng, ep.users[to] if ep.users else f"peer{to:02d}")
        return [
            Step(url=f"{ep.node_urls[peer]}/send",
                 payload={"to_username": ep.users[to] if ep.users
                          else f"peer{to:02d}", "content": msg}),
            Step(url=f"{ep.ui_urls[to]}/api/suggest/stream",
                 payload={"content": msg}, stream=True, measured=True),
        ]
    msg = _chat_text(rng, "there")
    return [Step(url=f"{ep.serve_url}/api/chat",
                 payload={"messages": [{"role": "user", "content": msg}],
                          "options": {"num_predict": 16}, "stream": True},
                 stream=True, measured=True)]


def _build_long_ctx(rng: random.Random, peer: int, ep: Endpoints) -> list:
    # ~3k byte-level tokens: unique head + filler body (the serve
    # tokenizer falls back to bytes for synthetic configs, so chars are
    # a faithful token-count proxy there).
    head = f"[long {rng.getrandbits(32):08x}] summarize this thread: "
    body = (_FILLER * (3000 // len(_FILLER) + 1))[: max(0, 3000 - len(head))]
    return [Step(url=f"{ep.serve_url}/api/generate",
                 payload={"prompt": head + body,
                          "options": {"num_predict": 16}, "stream": True},
                 stream=True, measured=True)]


def _build_embed(rng: random.Random, peer: int, ep: Endpoints) -> list:
    return [Step(url=f"{ep.serve_url}/api/embed",
                 payload={"input": [f"note {rng.getrandbits(32):08x}",
                                    "what time is the picnic?"]},
                 measured=True)]


def _build_unbounded(rng: random.Random, peer: int, ep: Endpoints) -> list:
    return [Step(url=f"{ep.serve_url}/api/generate",
                 payload={"prompt": _chat_text(rng, "all") + "\n\nReply:",
                          "options": {"num_predict": -1, "num_ctx": 64},
                          "stream": True},
                 stream=True, measured=True)]


def _build_park_wake(rng: random.Random, peer: int, ep: Endpoints) -> list:
    sid = f"lg-{peer}-{rng.getrandbits(32):08x}"
    base = (f"[{sid}] My favorite fruits are apples, pears and plums. "
            "Which should I bring to the picnic?")
    return [
        Step(url=f"{ep.serve_url}/api/generate",
             payload={"prompt": base, "options": {"num_predict": 8},
                      "stream": True},
             stream=True, session=sid),
        # Think time lets an idle-sweep engine park the session, so the
        # follow-up exercises the wake path rather than a hot hit.
        Step(url=f"{ep.serve_url}/api/generate",
             payload={"prompt": base + " Oh, and grapes too — rank them.",
                      "options": {"num_predict": 8}, "stream": True},
             stream=True, session=sid, pause_before_s=0.5, measured=True),
    ]


def _build_churn(rng: random.Random, peer: int, ep: Endpoints) -> list:
    """Three turns under one session id with think time between them —
    long enough for an idle-sweep engine to park between turns, and for
    a ChurnWindow's drain/undrain (or kill/respawn) pulse to land
    mid-conversation. With live migration the parked payload follows
    the affinity flip, so the judged final turn is a WAKE on the new
    home, not a cold re-prefill — zero session loss, bounded wake
    p95."""
    sid = f"churn-{peer}-{rng.getrandbits(32):08x}"
    base = (f"[{sid}] We are planning the team offsite: venue, budget, "
            "dates, and the dietary constraints list.")
    follow1 = " Which venue fits forty people?"
    follow2 = " And rank the three candidate dates."
    def step(prompt: str, measured: bool = False,
             pause: float = 0.0) -> Step:
        return Step(url=f"{ep.serve_url}/api/generate",
                    payload={"prompt": prompt,
                             "options": {"num_predict": 8},
                             "stream": True},
                    stream=True, session=sid, measured=measured,
                    pause_before_s=pause)
    return [
        step(base),
        step(base + follow1, pause=0.4),
        step(base + follow1 + follow2, measured=True, pause=0.4),
    ]


def _build_slow_reader(rng: random.Random, peer: int,
                       ep: Endpoints) -> list:
    """One NDJSON stream read adversarially: ~0 read rate via a
    per-line delay, and about half the arrivals disconnecting after the
    first delta (the mid-stream disconnect storm). Bounded: 8 deltas x
    40 ms keeps even the kept streams inside any sane wall budget."""
    abort = 1 if rng.random() < 0.5 else 0
    return [Step(url=f"{ep.serve_url}/api/generate",
                 payload={"prompt": _chat_text(rng, "slowly") + "\n\nReply:",
                          "options": {"num_predict": 8}, "stream": True},
                 stream=True, measured=True, read_delay_s=0.04,
                 abort_after_deltas=abort)]


GROUP_FANOUT = 3


def _build_group_chat(rng: random.Random, peer: int,
                      ep: Endpoints) -> list:
    """One inbound message, N concurrent co-pilot suggestions: the
    group-chat thundering herd. Every fan member carries IDENTICAL
    content on purpose — that is the shape that stresses the prefill
    pool (N admissions at once) and rewards the prefix cache (N
    identical heads). Judged as one unit by the fanout merge in
    driver.py."""
    if ep.node_urls and ep.ui_urls:
        n = len(ep.node_urls)
        to = (peer + 1) % n
        user = ep.users[to] if ep.users else f"peer{to:02d}"
        msg = _chat_text(rng, user)
        return [
            Step(url=f"{ep.node_urls[peer]}/send",
                 payload={"to_username": user, "content": msg}),
            Step(url=f"{ep.ui_urls[to]}/api/suggest/stream",
                 payload={"content": msg}, stream=True, measured=True,
                 fanout=GROUP_FANOUT),
        ]
    # Serve-only fallback: a SHORT herd on purpose (~40 byte tokens
    # rendered) — the group-chat shape is the concurrency, not the
    # prompt length, and staying under any admission chunk budget keeps
    # the disagg chaos leg's "zero chunks on decode replicas" assertion
    # exact even when a racy fan member cold-admits there.
    msg = (f"[{rng.getrandbits(32):08x}] lunch at "
           f"{11 + rng.randrange(3)}?")
    return [Step(url=f"{ep.serve_url}/api/chat",
                 payload={"messages": [{"role": "user", "content": msg}],
                          "options": {"num_predict": 8}, "stream": True},
                 stream=True, measured=True, fanout=GROUP_FANOUT)]


def _build_relay_path(rng: random.Random, peer: int,
                      ep: Endpoints) -> list:
    """One node ``/send`` between the ring's most distant peer pair,
    measured on the /send round trip itself (non-streaming: latency =
    full delivery). Aiming half the ring away maximises the odds the
    pair sits across whatever NAT blocklist the run arms, so delivery
    rides the relay splice — and the arrival's ``node.send`` span
    (via=relay|direct) shows which leg actually carried it. Needs at
    least two nodes; otherwise a serve-level short turn keeps the
    arrival judgeable."""
    if len(ep.node_urls) >= 2:
        n = len(ep.node_urls)
        to = (peer + max(1, n // 2)) % n
        user = ep.users[to] if ep.users else f"peer{to:02d}"
        return [Step(url=f"{ep.node_urls[peer % n]}/send",
                     payload={"to_username": user,
                              "content": _chat_text(rng, user)},
                     measured=True)]
    msg = _chat_text(rng, "far away")
    return [Step(url=f"{ep.serve_url}/api/chat",
                 payload={"messages": [{"role": "user", "content": msg}],
                          "options": {"num_predict": 16}, "stream": True},
                 stream=True, measured=True)]


def _build_peer_churn(rng: random.Random, peer: int,
                      ep: Endpoints) -> list:
    """One node ``/send`` to the ring neighbour, measured on the /send
    round trip — the arrival shape the peer_churn chaos window
    (chaos.NodeChurnWindow) kills nodes under. The sender's answer is
    "sent" on a live recipient and the well-formed queued 200 on a dead
    one; BOTH are fast local work, so the latency class matches
    relay_path's. Arrivals aimed AT the killed node's own HTTP front
    error out — that is the ~1/N collateral of real process death, and
    it belongs to the error budget, not the SLO. Serve-only runs
    degrade to a short ``/api/chat`` turn."""
    if ep.node_urls:
        n = len(ep.node_urls)
        to = (peer + 1) % n
        user = ep.users[to] if ep.users else f"peer{to:02d}"
        return [Step(url=f"{ep.node_urls[peer % n]}/send",
                     payload={"to_username": user,
                              "content": _chat_text(rng, user)},
                     measured=True)]
    msg = _chat_text(rng, "whoever is up")
    return [Step(url=f"{ep.serve_url}/api/chat",
                 payload={"messages": [{"role": "user", "content": msg}],
                          "options": {"num_predict": 16}, "stream": True},
                 stream=True, measured=True)]


# The multi_model arrival split: this fraction of arrivals hits the
# FIRST tag (the interactive default); the rest hit the second (the
# large trunk). A fixed constant, not an env knob — the determinism
# contract pins the schedule AND the per-arrival picks to the seed, and
# a knob that skews the split would silently re-weight the judged
# phases between runs that claim the same seed.
MULTI_MODEL_SPLIT = 0.75


def _multi_model_tags() -> tuple:
    """``LOADGEN_MODELS=tagA,tagB`` -> ("tagA", "tagB"): the two
    ``SERVE_MODELS`` tags the multi_model scenario spreads arrivals
    across. Read at BUILD time, not import, so the launcher can export
    it after this module loads. Degrades: unset = no ``model`` field on
    any step (the engine's default serves everything — single-model
    runs stay judgeable); one tag = both classes pin that tag (the
    phase split still measures, it just measures one model)."""
    return tuple(t.strip()
                 for t in env_or("LOADGEN_MODELS", "").split(",")
                 if t.strip())


def _build_multi_model(rng: random.Random, peer: int,
                       ep: Endpoints) -> list:
    """One short generate turn aimed at a per-arrival model pick: the
    heterogeneous-fleet shape the large-MoE configs exist for —
    a run serving ``tiny`` and ``mixtral-large`` side by side must keep
    the interactive class fast WHILE the expert trunk decodes. The
    phase tag carries the pick into the ledger's per-phase judgement
    (report.py), so a miss names the model class, not the blend."""
    tags = _multi_model_tags()
    big = rng.random() >= MULTI_MODEL_SPLIT
    phase = "model_b" if big else "model_a"
    payload: dict = {"prompt": _chat_text(rng, "whichever model")
                     + "\n\nReply:",
                     "options": {"num_predict": 8}, "stream": True}
    if tags:
        payload["model"] = tags[1] if big and len(tags) > 1 else tags[0]
    return [Step(url=f"{ep.serve_url}/api/generate", payload=payload,
                 stream=True, measured=True, phase=phase)]


def _build_disagg_session(rng: random.Random, peer: int,
                          ep: Endpoints) -> list:
    """Two turns under one session id, phase-tagged: turn 1 is a NEW
    conversation — on a disaggregated fleet it chunk-prefills on the
    prefill pool and rides the handoff (its first-delta latency lands
    under ``phase="prefill"``, charging prefill + handoff overhead to
    the right pool); turn 2 extends the prompt after think time, a
    verify-shaped wake on the decode replica (``phase="decode"``, the
    judged step). On an undisaggregated fleet this is ordinary two-turn
    session traffic — the phases still record, just both served by the
    same pool."""
    sid = f"disagg-{peer}-{rng.getrandbits(32):08x}"
    # ~120 byte-level tokens: above a 64-token prefill-chunk budget
    # (the chaos leg pins "admission chunks stay on the prefill pool"
    # with it), while keeping the session shallow enough that the
    # post-handoff wake fits small test engines' 256-token budget (the
    # wake suffix rounds UP to the smallest warmed bucket, so session
    # depth + 64 must stay inside max_seq).
    base = (f"[{sid}] Compare the three candidate venues on cost, "
            "capacity and transit access, then pick exactly one.")
    return [
        Step(url=f"{ep.serve_url}/api/generate",
             payload={"prompt": base, "options": {"num_predict": 8},
                      "stream": True},
             stream=True, session=sid, phase="prefill",
             carry_context=True),
        # Turn 2 sends ONLY the new text plus the turn-1 context ids —
        # the real-client continuation shape, and the one whose token
        # ids extend the migrated session so the decode replica WAKES
        # it instead of re-prefilling the history.
        Step(url=f"{ep.serve_url}/api/generate",
             payload={"prompt": " Now justify that pick briefly.",
                      "options": {"num_predict": 8}, "stream": True},
             stream=True, session=sid, measured=True, phase="decode",
             pause_before_s=0.4, use_context=True),
    ]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY: dict = {
    s.name: s for s in (
        Scenario("short_chat", weight=4.0,
                 slo=SLO(ttft_p50_ms=4000, ttft_p95_ms=12000,
                         itl_p95_ms=2000, max_shed_frac=0.25),
                 build=_build_short_chat),
        Scenario("long_ctx", weight=1.0,
                 slo=SLO(ttft_p50_ms=8000, ttft_p95_ms=20000,
                         itl_p95_ms=2000, max_shed_frac=0.25),
                 build=_build_long_ctx),
        Scenario("embed", weight=1.0,
                 slo=SLO(ttft_p50_ms=4000, ttft_p95_ms=12000,
                         itl_p95_ms=None, max_shed_frac=0.25),
                 build=_build_embed),
        Scenario("unbounded", weight=1.0,
                 slo=SLO(ttft_p50_ms=4000, ttft_p95_ms=12000,
                         itl_p95_ms=2000, max_shed_frac=0.25),
                 build=_build_unbounded),
        Scenario("park_wake", weight=1.0,
                 slo=SLO(ttft_p50_ms=5000, ttft_p95_ms=15000,
                         itl_p95_ms=2000, max_shed_frac=0.25),
                 build=_build_park_wake),
        # Fleet-churn traffic: judged on the post-churn wake
        # turn; the shed budget is wider — a drain window legitimately
        # sheds the arrivals that race it, all well-formed.
        Scenario("churn", weight=0.5,
                 slo=SLO(ttft_p50_ms=6000, ttft_p95_ms=18000,
                         itl_p95_ms=2000, max_shed_frac=0.4),
                 build=_build_churn),
        # Adversarial clients: itl is None on purpose — the inter-line
        # gaps are the CLIENT's own read delay, not server latency.
        Scenario("slow_reader", weight=0.5,
                 slo=SLO(ttft_p50_ms=5000, ttft_p95_ms=15000,
                         itl_p95_ms=None, max_shed_frac=0.25),
                 build=_build_slow_reader),
        # The thundering herd: TTFT is the WORST of the N
        # concurrent fan members, so the target is wider than a single
        # stream's; the shed budget too (a saturated herd legitimately
        # sheds some of its fan).
        Scenario("group_chat", weight=0.5,
                 slo=SLO(ttft_p50_ms=6000, ttft_p95_ms=18000,
                         itl_p95_ms=2000, max_shed_frac=0.3),
                 build=_build_group_chat),
        # The relay leg: a non-streaming /send, so itl is
        # None and TTFT is the whole delivery — relay splice included
        # when the fleet's NAT blocklist forces it. The budget matches
        # short_chat's: a relayed hop is one extra stream splice, not a
        # different latency class.
        Scenario("relay_path", weight=0.5,
                 slo=SLO(ttft_p50_ms=4000, ttft_p95_ms=12000,
                         itl_p95_ms=None, max_shed_frac=0.25),
                 build=_build_relay_path),
        # Peer churn: a non-streaming /send judged through a
        # NodeChurnWindow kill/restart pulse, so itl is None and TTFT
        # is the sender's local answer — "sent" or the queued 200, both
        # bounded by the outbox enqueue, never by the dead peer. The
        # shed/error headroom is churn-wide: arrivals racing the kill
        # against the dead node's own front are real connection errors.
        Scenario("peer_churn", weight=0.5,
                 slo=SLO(ttft_p50_ms=4000, ttft_p95_ms=12000,
                         itl_p95_ms=None, max_shed_frac=0.4),
                 build=_build_peer_churn),
        # Heterogeneous models: the blended scenario SLO is
        # sized for the mix; the per-phase SLOs split misses by MODEL
        # class — model_a holds the interactive default's tight budget,
        # model_b the large-MoE trunk's wider one (an 8-expert pool
        # legitimately decodes slower per token; what it may NOT do is
        # drag the interactive class down with it, which is exactly
        # what a model_a phase violation would read as).
        Scenario("multi_model", weight=0.5,
                 slo=SLO(ttft_p50_ms=6000, ttft_p95_ms=18000,
                         itl_p95_ms=2500, max_shed_frac=0.3),
                 build=_build_multi_model,
                 phase_slos={
                     "model_a": SLO(ttft_p50_ms=4000, ttft_p95_ms=12000,
                                    itl_p95_ms=2000, max_shed_frac=0.3),
                     "model_b": SLO(ttft_p50_ms=8000, ttft_p95_ms=20000,
                                    itl_p95_ms=3000, max_shed_frac=0.3),
                 }),
        # Disaggregated session: judged on the turn-2 wake;
        # the per-phase SLOs split misses by pool — prefill's budget is
        # wider (it carries the chunked prefill AND the handoff), the
        # decode phase holds the tight wake number. The prefill phase
        # judges no itl: its stream's gaps belong to whichever pool
        # decoded turn 1, not to admission.
        Scenario("disagg_session", weight=0.5,
                 slo=SLO(ttft_p50_ms=5000, ttft_p95_ms=15000,
                         itl_p95_ms=2000, max_shed_frac=0.3),
                 build=_build_disagg_session,
                 phase_slos={
                     "prefill": SLO(ttft_p50_ms=8000, ttft_p95_ms=20000,
                                    itl_p95_ms=None, max_shed_frac=0.3),
                     "decode": SLO(ttft_p50_ms=5000, ttft_p95_ms=15000,
                                   itl_p95_ms=2000, max_shed_frac=0.3),
                 }),
    )
}


def default_mix() -> list:
    """[(scenario, weight), ...] in registry order."""
    return [(s, s.weight) for s in REGISTRY.values()]


def parse_mix(spec: str) -> list:
    """``"short_chat=4,embed=1"`` -> [(scenario, weight), ...]. Unknown
    names and non-positive weights fail loudly (a typo'd mix must not
    silently drop a scenario class). Empty spec = the default mix."""
    if not spec.strip():
        return default_mix()
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, w = entry.partition("=")
        name = name.strip()
        if name not in REGISTRY:
            raise ValueError(
                f"unknown scenario {name!r} (have: {sorted(REGISTRY)})")
        weight = float(w) if sep else REGISTRY[name].weight
        if weight <= 0:
            raise ValueError(f"scenario weight must be > 0: {entry!r}")
        out.append((REGISTRY[name], weight))
    if not out:
        raise ValueError(f"empty scenario mix: {spec!r}")
    return out
