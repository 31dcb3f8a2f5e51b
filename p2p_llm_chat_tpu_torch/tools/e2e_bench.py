"""End-to-end loadgen CLI of the port: the chat plane under open-loop
scenario load, against the port's serve entry — the twin of the
repository's ``tools/e2e_bench.py``.

Thin operator front over ``p2p_llm_chat_tpu_torch.loadgen``: boots the
full deployment via the port's launcher (``python -m
p2p_llm_chat_tpu_torch.start_all``: directory, serve front, N node
daemons, N UI servers — staged boot waves at 64–128 peers), then
drives the seeded open-loop Poisson scenario mix through
the real wire paths (UI ``/api/suggest/stream``, node ``/send``, serve
``/api/generate|chat|embed``), judges the run against the per-scenario
SLOs, and records the ledger row DURABLY as ``E2E_r0N.json`` (the
``BENCH_r0N.json`` convention) into ``--out-dir`` — an error row if the
run dies, never stdout-only. The row also carries the boot's walls
(``boot``: the quote checkpoint's build, the serve child's launch to
``/readyz``, the nodes' and UIs' boot, the warm-up).

Chaos rides along instead of beside: ``--chaos`` arms ``FAIL_POINTS``
in every launched process at low probability for the whole run, and the
ledger re-asserts the front's degradation contracts under load (sheds
answered <100 ms with Retry-After, no hung streams, stack still answers
after the run).

``--churn`` adds real peer churn on top: a NodeChurnWindow SIGKILLs one
launched node mid-run and respawns it with its captured environment,
then the ledger asserts every outbox drained (the at-least-once
redelivery contract). ``--relay``
boots the circuit relay so relay_path traffic rides the splice. The
launched profile turns directory liveness on (``DIR_TTL_S=60``).

``--backend torch`` serves the port's engine on the card (set
``SERVE_DEVICE=cpu`` in the environment to serve on the CPU); with no
card and no such request the serve child raises and the boot fails.
The quote workload's checkpoint is an HF safetensors directory drawn by
``models/synth.quote_params`` and written by
``models/weights.save_checkpoint`` in a subprocess (this module imports
no ``torch``); ``E2E_CKPT_DIR`` caches it across runs under the port's
own marker file.

Usage:
    python -m p2p_llm_chat_tpu_torch.tools.e2e_bench --peers 32 \
        --backend torch --config llama3.1-8b --rate 8 --duration 20 \
        --relay --out-dir /tmp/e2e
    python -m p2p_llm_chat_tpu_torch.tools.e2e_bench --stub --duration 3

In containers without the ``cryptography`` package the node plane runs
the explicit INSECURE dev fallback (p2p/devcrypto.py) — set
automatically, flagged in the row as ``"dev_crypto": true``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import shutil
import threading
import time
import urllib.error
import urllib.request

from ..loadgen import (ChaosWindow, Endpoints, LoadDriver, NodeChurnWindow,
                       REGISTRY, build_ledger, build_schedule,
                       check_contracts, error_row, fetch_timelines,
                       parse_mix, write_row)
from ..loadgen.chaos import parse_fail_points
from ..utils.env import env_float, env_int, env_or

PKG = "p2p_llm_chat_tpu_torch"
# The repository root: the package's parent, where the children run.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The quote checkpoint's completeness marker, written last (never the
# reference's native_meta.json: the port refuses that directory).
QUOTE_MARKER = "e2e_quote.json"

# The serve children's profile: each a default the caller's environment
# overrides (SERVE_SLOTS comes from --slots, UI_SUGGEST_PREDICT from
# --suggest-predict).
SERVE_PROFILE = (
    ("SERVE_MAX_SEQ", "4096"),
    ("SERVE_KV", "paged"),
    ("SERVE_QUANT", "int8"),
    ("SERVE_KV_QUANT", "int8"),
    # The warmup ladder includes the top prompt bucket: the long-context
    # scenario's ~3k-token prompts land there, and a bucket the warmup
    # missed runs its first admission (and captures its graphs)
    # mid-serving, stalling every live stream.
    ("SERVE_WARMUP", "64,128,256,4096"),
    # An 8B checkpoint boot (16 GB streamed onto the card, int8
    # quantized, the warmup's graph captures); the launcher waits this
    # long at most.
    ("SERVE_WAIT_S", "1800"),
)


def wait_http(url: str, deadline_s: float = 240.0,
              launcher: "subprocess.Popen | None" = None) -> None:
    """Poll until 200. A dead launcher fails FAST with its captured
    output tail — not after burning the full deadline (a boot crash
    would otherwise mean up to 1800 s of silence)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if launcher is not None:
            code = launcher.poll()
            if code is not None:
                raise RuntimeError(
                    f"launcher exited with code {code} while waiting for "
                    f"{url} (tail: "
                    f"{b''.join(globals().get('_TAIL', []))[-1200:]!r})")
        try:
            urllib.request.urlopen(url, timeout=2)
            return
        except Exception:
            time.sleep(0.5)
    raise RuntimeError(f"{url} never came up (launcher tail: "
                       f"{b''.join(globals().get('_TAIL', []))[-800:]!r})")


def post(url: str, body: dict, timeout: float = 120.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        # Surface the error BODY (the per-request reason) and the
        # launcher tail — a bare "HTTP 500" is undebuggable after the
        # stack is torn down.
        detail = e.read()[:500]
        tail = b"".join(globals().get("_TAIL", []))[-1500:]
        raise RuntimeError(
            f"{url} -> HTTP {e.code}: {detail!r} (launcher tail: "
            f"{tail!r})") from None


# The checkpoint build, run in a subprocess of its own so the card is
# free again (the process gone) before the serve child loads it.
_QUOTE_BUILD = """
import json, sys, time
t0 = time.monotonic()
import torch
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.synth import quote_params
from p2p_llm_chat_tpu_torch.models.weights import save_checkpoint
config, out = sys.argv[1], sys.argv[2]
cfg = get_config(config)
t1 = time.monotonic()
params = quote_params(cfg, quant="")
if params["embed"].is_cuda:
    torch.cuda.synchronize()
t2 = time.monotonic()
st = save_checkpoint(out, params, cfg)
st.update(import_s=t1 - t0, draw_s=t2 - t1, save_s=time.monotonic() - t2,
          device=str(params["embed"].device))
print("QUOTE_CKPT " + json.dumps(st), flush=True)
"""

# What a stale cache may hold: the reference's native checkpoint (its
# marker and Orbax tree) and the files this module writes.
_STALE = ("native_meta.json", "params", "config.json",
          "model.safetensors.index.json", QUOTE_MARKER)


def _clear_stale(ckpt_dir: str) -> None:
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name in _STALE or name.endswith(".safetensors"):
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)


def build_quote_checkpoint(config: str, env: dict) -> dict:
    """Synthetic quote checkpoint (models/synth.quote_params, bf16) as an
    HF safetensors directory (models/weights.save_checkpoint), built in a
    subprocess on the device ``env`` selects (the card unless
    ``SERVE_DEVICE=cpu``), which exits before the serve child starts.
    ``E2E_CKPT_DIR`` caches it across runs under :data:`QUOTE_MARKER`
    (written last): at 8B dims it is 16 GB. A directory holding another
    config, or the reference's native checkpoint, is cleared and
    rebuilt. Without ``E2E_CKPT_DIR`` the directory is a temporary one
    (``"temporary": True``) that the run removes at teardown. Sets
    ``CKPT_DIR`` / ``LLM_MODEL`` in ``env``; returns the build's walls
    (``{"cached": True}`` on a reuse)."""
    cache = os.environ.get("E2E_CKPT_DIR", "")
    marker = os.path.join(cache, QUOTE_MARKER) if cache else ""
    cached_cfg = None
    if marker and os.path.exists(marker):
        with open(marker) as f:
            cached_cfg = json.load(f).get("config")
    env["LLM_MODEL"] = config
    if cached_cfg == config:
        env["CKPT_DIR"] = cache
        return {"cached": True}
    ckpt_dir = cache or tempfile.mkdtemp(prefix="e2e_quote_")
    os.makedirs(ckpt_dir, exist_ok=True)
    if cache:
        if cached_cfg is not None or os.listdir(ckpt_dir):
            print(f"E2E_CKPT_DIR holds {cached_cfg or 'another checkpoint'!r}"
                  f", need {config!r}; rebuilding", file=sys.stderr)
        _clear_stale(ckpt_dir)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", _QUOTE_BUILD, config,
                          ckpt_dir], env=env, cwd=REPO, check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    stats = next(json.loads(line.split(" ", 1)[1])
                 for line in out.splitlines()
                 if line.startswith("QUOTE_CKPT "))
    stats["wall_s"] = time.monotonic() - t0
    with open(os.path.join(ckpt_dir, QUOTE_MARKER), "w") as f:
        json.dump({"config": config, "workload": "quote",
                   "format": "hf-safetensors"}, f)
    env["CKPT_DIR"] = ckpt_dir
    return {"cached": False, "temporary": not cache, **stats}


def parse_churn(spec: str) -> dict:
    """'peer=3,kill_at=20,restart_at=45' -> kwargs for the churn window.
    Typos fail at parse time, before any boot (the --chaos discipline)."""
    out = {"peer": 0, "kill_at": 20.0, "restart_at": 45.0}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, sep, val = part.partition("=")
        if not sep or key not in out:
            raise SystemExit(f"bad --churn entry {part!r} "
                             "(want peer=K,kill_at=S,restart_at=S)")
        out[key] = int(val) if key == "peer" else float(val)
    if out["restart_at"] <= out["kill_at"]:
        raise SystemExit("--churn restart_at must be after kill_at")
    return out


def find_node_proc(port: int) -> "tuple[int, dict[str, str]]":
    """Locate the launched node listening on ``port`` by scanning
    /proc/*/environ for its HTTP_ADDR — the launcher owns the Popen
    handles, so the churn window has to find its victim from outside.
    Only a process whose command line runs the port's node module
    (``-m p2p_llm_chat_tpu_torch.node``, that argument exactly) matches.
    Returns (pid, env snapshot) so the respawn reproduces the victim's
    exact configuration (username, ports, FAIL_POINTS, relay addrs)."""
    needle = f"HTTP_ADDR=127.0.0.1:{port}".encode()
    module = f"{PKG}.node".encode()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                raw = f.read()
            if needle not in raw:
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if module not in f.read().split(b"\0"):
                    continue
        except OSError:   # raced a process exit
            continue
        env = dict(kv.split("=", 1)
                   for kv in raw.decode("utf-8", "replace").split("\0")
                   if "=" in kv)
        return int(pid), env
    raise RuntimeError(f"no node process found on port {port}")


def outboxes_drained(node_urls: "tuple[str, ...]",
                     deadline_s: float = 90.0) -> bool:
    """Poll every node's /metrics until all p2p_outbox_depth gauges read
    zero — the cheap fleet-wide proxy for 'every message queued during
    the churn window was redelivered' (per-inbox dedup makes that
    exactly-once; tests/test_node_churn.py pins the strict oracle)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        depths = []
        for url in node_urls:
            try:
                with urllib.request.urlopen(f"{url}/metrics",
                                            timeout=5) as r:
                    text = r.read().decode()
                for line in text.splitlines():
                    if line.startswith("p2p_outbox_depth"):
                        depths.append(float(line.split()[-1]))
            except Exception:
                depths.append(-1.0)   # unreachable node: keep polling
        if depths and all(d == 0.0 for d in depths):
            return True
        time.sleep(1.0)
    return False


def kernel_launches(serve_url: str) -> dict:
    """The serve process's kernel launches by wrapper, from its
    ``kernel_launches_total`` series on ``/metrics`` ({} where the front
    has none: FakeLLM, or the router)."""
    with urllib.request.urlopen(f"{serve_url}/metrics", timeout=10) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith('kernel_launches_total{kernel="'):
            name = line.split('"', 2)[1]
            out[name] = int(float(line.rsplit(" ", 1)[1]))
    return out


def drive(ep: Endpoints, args, chaos: "ChaosWindow | None") -> dict:
    """Schedule + drive + judge: the loadgen core, shared by the
    launcher and --stub paths."""
    mix = parse_mix(args.mix)
    schedule = build_schedule(mix, rate_rps=args.rate,
                              duration_s=args.duration, seed=args.seed,
                              n_peers=max(1, len(ep.ui_urls) or args.peers))
    print(f"schedule: {len(schedule)} arrivals over {args.duration}s "
          f"(rate {args.rate}/s, seed {args.seed})", file=sys.stderr)
    driver = LoadDriver(ep, REGISTRY, workers=args.workers,
                        timeout_s=args.timeout)
    t0 = time.monotonic()
    records = driver.run(schedule, chaos=chaos)
    wall = time.monotonic() - t0
    contract = check_contracts(
        records,
        disarm_at_s=chaos.disarm_at_s if chaos is not None else None)
    # Breach attribution: lazy per-trace fetch against the serve front
    # (or router — both expose /admin/trace; the router merges). Only
    # SLO-breached requests pay a fetch, so a clean run costs nothing.
    row = build_ledger(records, REGISTRY, duration_s=args.duration,
                       contract=contract,
                       timelines=fetch_timelines(ep.serve_url))
    row["wall_s"] = round(wall, 2)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--peers", type=int, default=32)
    ap.add_argument("--config", default="bench-1b")
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "fake"],
                    help="serve backend: torch = the port's engine (on "
                         "the card unless SERVE_DEVICE=cpu is in the "
                         "environment), fake = FakeLLM echo (chat-plane-"
                         "only runs)")
    # Default bases sit BELOW common ephemeral-port floors (32768
    # standard, 16000 in some containers): at 64–128 peers the wide
    # node/UI ranges otherwise collide with the outbound source ports
    # of ~2N booting processes — observed as a random node dying with
    # EADDRINUSE mid-boot. The launcher's port check warns on overlap.
    ap.add_argument("--node-base", type=int, default=12081)
    ap.add_argument("--ui-base", type=int, default=12501)
    ap.add_argument("--dir-port", type=int, default=12480)
    ap.add_argument("--serve-port", type=int, default=12490)
    ap.add_argument("--rate", type=float,
                    default=env_float("LOADGEN_RATE", 8.0),
                    help="open-loop Poisson arrival rate, 1/s")
    ap.add_argument("--duration", type=float,
                    default=env_float("LOADGEN_DURATION_S", 60.0))
    ap.add_argument("--seed", type=int, default=env_int("LOADGEN_SEED", 0))
    ap.add_argument("--workers", type=int,
                    default=env_int("LOADGEN_WORKERS", 64),
                    help="bounded executor pool (a stall surfaces as "
                         "SLO-visible lag, never generator backpressure)")
    ap.add_argument("--timeout", type=float,
                    default=env_float("LOADGEN_TIMEOUT_S", 120.0))
    ap.add_argument("--mix", default=env_or("LOADGEN_MIX", ""),
                    help="scenario weights, e.g. 'short_chat=4,embed=1' "
                         "(default: registry weights)")
    ap.add_argument("--chaos", default=env_or("LOADGEN_CHAOS", ""),
                    help="FAIL_POINTS grammar armed in EVERY launched "
                         "process for the whole run, e.g. "
                         "'serve.api.stream=drop@0.02,p2p.dht.rpc="
                         "drop@0.05'")
    ap.add_argument("--relay", action="store_true",
                    help="also start the circuit relay (the launcher's "
                         "--relay): nodes hold reservations, and the "
                         "relay_path scenario's NAT-blocked pair rides "
                         "the splice instead of degrading to a direct "
                         "dial")
    ap.add_argument("--churn", default=env_or("LOADGEN_CHURN", ""),
                    help="arm peer churn mid-run: 'peer=K,kill_at=S,"
                         "restart_at=S' SIGKILLs the K-th launched node "
                         "and respawns it with its captured environment "
                         "— directory re-register plus the at-least-"
                         "once outbox must hand every queued message "
                         "over after the restart")
    ap.add_argument("--boot-wave", type=int,
                    default=env_int("LOADGEN_BOOT_WAVE", 8))
    ap.add_argument("--slots", type=int, default=0,
                    help="SERVE_SLOTS override (default: peers, capped "
                         "at 32 — undersize it to find the overload "
                         "edge)")
    ap.add_argument("--queue-max", type=int, default=-1,
                    help="SERVE_QUEUE_MAX override (sizes the shed "
                         "edge; -1 = server auto)")
    ap.add_argument("--replicas", type=int,
                    default=env_int("SERVE_REPLICAS", 0),
                    help="mixed-replica fleet: N >= 2 serve processes "
                         "behind the router (the launcher's --replicas)")
    ap.add_argument("--prefill", type=int,
                    default=env_int("SERVE_PREFILL_REPLICAS", 0),
                    help="disaggregated fleet: N prefill-class replicas "
                         "(the launcher's --prefill)")
    ap.add_argument("--decode", type=int,
                    default=env_int("SERVE_DECODE_REPLICAS", 0),
                    help="disaggregated fleet: M decode-class replicas "
                         "(the launcher's --decode)")
    ap.add_argument("--suggest-predict", type=int, default=24,
                    help="UI_SUGGEST_PREDICT for the launched UIs: token "
                         "bound on co-pilot suggestions (0 = reference "
                         "behavior, the server's 256 default)")
    ap.add_argument("--out-dir", default=REPO,
                    help="directory for the durable E2E_r0N.json row")
    ap.add_argument("--no-row", action="store_true",
                    help="print the ledger only; skip the durable row")
    ap.add_argument("--stub", action="store_true",
                    help="drive the in-process stub server instead of "
                         "launching the stack (CI smoke; implies "
                         "--no-row unless --out-dir is explicit)")
    ap.add_argument("--workload", default="quote",
                    choices=["quote", "random"],
                    help="quote (default): serve a synthetic checkpoint "
                         "whose output is a repeating printable phrase "
                         "(models/synth.py) so suggestions stream as "
                         "text; random: raw random init (non-UTF-8 "
                         "streams buffer in the detokenizer)")
    args = ap.parse_args()
    if args.chaos:
        parse_fail_points(args.chaos)   # typos fail before any boot
    churn_spec = parse_churn(args.churn) if args.churn else None

    meta = {"peers": args.peers, "config": args.config,
            "backend": args.backend, "rate_rps": args.rate,
            "seed": args.seed, "mix": args.mix or "default",
            "chaos_spec": args.chaos or None,
            "relay": bool(args.relay),
            "churn_spec": args.churn or None,
            # Class topology: disagg rows must be distinguishable from
            # mixed rows at a glance — a
            # decode_stall_ms ~0 claim means nothing without the fleet
            # shape that produced it.
            "topology": ({"prefill": args.prefill, "decode": args.decode,
                          "mixed": args.replicas}
                         if (args.prefill or args.decode)
                         else {"mixed": args.replicas or 1}),
            "path": "UI HTTP -> serve front -> scheduler -> card; "
                    "node /send -> encrypted stream -> peer inbox"}

    if args.stub:
        from ..loadgen import StubServer
        stub = StubServer(ttft_s=0.005, itl_s=0.002, deltas=4).start()
        try:
            n = max(1, min(args.peers, 8))
            ep = Endpoints(serve_url=stub.url, ui_urls=(stub.url,) * n,
                           node_urls=(stub.url,) * n,
                           users=tuple(f"peer{i:02d}" for i in range(n)))
            chaos = (ChaosWindow(args.chaos,
                                 disarm_at_s=args.duration * 0.75)
                     if args.chaos else None)
            row = drive(ep, args, chaos)
            row.update(meta)
            row["stub"] = True
            if args.out_dir != REPO and not args.no_row:
                # An explicitly-chosen out dir opts the stub smoke back
                # into a durable row (per the --stub help text); the
                # default never pollutes the repo's E2E_r0N sequence.
                path = write_row(row, args.out_dir)
                print(f"ledger row -> {path}", file=sys.stderr)
            print(json.dumps(row), flush=True)
            return 0 if row["verdict"] == "pass" else 1
        finally:
            stub.stop()

    n = args.peers
    users = [f"peer{i:02d}" for i in range(n)]
    dev_crypto = importlib.util.find_spec("cryptography") is None
    meta["dev_crypto"] = dev_crypto

    env = dict(
        os.environ,
        MODEL_CONFIG=args.config,
        SERVE_SLOTS=str(args.slots or min(n, 32)),
        LOADGEN_BOOT_WAVE=str(args.boot_wave),
        # PREPEND to PYTHONPATH: the caller's own entries stay.
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    for k, v in SERVE_PROFILE:
        env.setdefault(k, v)
    # Loopback deployment: don't probe the host's real gateway for
    # NAT-PMP from 64–128 nodes (explicit NATPMP=1 in the caller's env
    # still wins).
    env.setdefault("NATPMP", "0")
    # The loadgen profile turns directory liveness ON (off by default
    # for reference contract parity): records older than DIR_TTL_S are
    # evicted, so a peer that dies and stays dead stops resolving and
    # senders park messages in the outbox instead of dialing a corpse.
    # 60 s = two NODE_REREGISTER_S heartbeats of slack.
    env.setdefault("DIR_TTL_S", "60")
    # Bound the co-pilot suggestion length (the reference sends no
    # num_predict, i.e. the server's 256 default — the single biggest
    # per-request cost; one short sentence is the product-shaped reply).
    env.setdefault("UI_SUGGEST_PREDICT", str(args.suggest_predict))
    if args.queue_max >= 0:
        env["SERVE_QUEUE_MAX"] = str(args.queue_max)
    # The serve profile this run's children get, for the row's reader.
    meta["serve_env"] = {k: env[k] for k in (
        "SERVE_SLOTS", *dict(SERVE_PROFILE), "UI_SUGGEST_PREDICT")}
    if dev_crypto:
        print("NOTE: 'cryptography' not installed — node plane runs the "
              "INSECURE dev fallback (P2P_DEV_CRYPTO=1, p2p/devcrypto.py)",
              file=sys.stderr)
        env["P2P_DEV_CRYPTO"] = "1"
    if args.chaos:
        env["FAIL_POINTS"] = args.chaos
    boot: dict = {}
    meta["boot"] = boot
    if args.workload == "quote" and args.backend == "torch":
        boot["quote_ckpt"] = build_quote_checkpoint(args.config, env)

    launch_cmd = [sys.executable, "-m", f"{PKG}.start_all",
                  "--backend", args.backend, "--users", ",".join(users),
                  "--node-port-base", str(args.node_base),
                  "--ui-port-base", str(args.ui_base),
                  "--dir-port", str(args.dir_port),
                  "--serve-port", str(args.serve_port),
                  "--boot-wave", str(args.boot_wave)]
    if args.replicas:
        launch_cmd += ["--replicas", str(args.replicas)]
    if args.prefill:
        launch_cmd += ["--prefill", str(args.prefill)]
    if args.decode:
        launch_cmd += ["--decode", str(args.decode)]
    if args.relay:
        launch_cmd += ["--relay"]
    if churn_spec is not None:
        # The launcher must forgive the victim's death — the churn
        # window SIGKILLs it on purpose and owns the respawn.
        launch_cmd += ["--churn-tolerant"]
    t_launch = time.monotonic()
    launcher = subprocess.Popen(
        launch_cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    # Drain launcher output (an undrained PIPE fills and BLOCKS the
    # launcher mid-boot); keep a tail for diagnostics.
    tail: list[bytes] = []
    globals()["_TAIL"] = tail

    def drain() -> None:
        for line in launcher.stdout:
            tail.append(line)
            del tail[:-80]

    threading.Thread(target=drain, daemon=True).start()

    serve_url = f"http://127.0.0.1:{args.serve_port}"
    row: dict = {}
    rc = 1
    # Churn respawns are OUR children, not the launcher's — tracked so
    # teardown reaps them (launcher.terminate() can't see them).
    respawned: "list[subprocess.Popen]" = []
    try:
        try:
            # The launcher boots the serve front FIRST (weights onto the
            # card and the warmup can take minutes) and gates the node/UI
            # waves on its /readyz.
            wait_http(f"{serve_url}/readyz", deadline_s=1800.0,
                      launcher=launcher)
            t_ready = time.monotonic()
            boot["serve_ready_s"] = round(t_ready - t_launch, 3)
            for i in range(n):
                wait_http(f"http://127.0.0.1:{args.node_base + i}/healthz",
                          launcher=launcher)
                wait_http(f"http://127.0.0.1:{args.ui_base + i}/",
                          launcher=launcher)
            t_peers = time.monotonic()
            boot["peers_ready_s"] = round(t_peers - t_ready, 3)
            # Warm the serving path: compiles any admission/decode
            # program the warmup ladder missed, so the measured run sees
            # steady-state TTFT (bench.py does the same).
            post(f"{serve_url}/api/generate",
                 {"model": args.config, "prompt": "warm", "stream": False,
                  "options": {"num_predict": 4}}, timeout=900).read()
            post(f"http://127.0.0.1:{args.ui_base}/api/suggest",
                 {"content": "warmup message, please ignore"},
                 timeout=900).read()
            boot["warm_s"] = round(time.monotonic() - t_peers, 3)

            ep = Endpoints(
                serve_url=serve_url,
                ui_urls=tuple(f"http://127.0.0.1:{args.ui_base + i}"
                              for i in range(n)),
                node_urls=tuple(f"http://127.0.0.1:{args.node_base + i}"
                                for i in range(n)),
                users=tuple(users))
            # Env-armed chaos spans the whole run (every process arms at
            # boot); the window object only annotates — recovery is the
            # post-run probe below.
            chaos = (ChaosWindow(args.chaos, in_process=False)
                     if args.chaos else None)
            window = None
            if churn_spec is not None:
                victim = churn_spec["peer"] % n
                victim_port = args.node_base + victim
                victim_env: dict = {}

                def kill_victim() -> None:
                    pid, env_snap = find_node_proc(victim_port)
                    victim_env.update(env_snap)
                    os.kill(pid, signal.SIGKILL)

                def restart_victim() -> None:
                    respawned.append(subprocess.Popen(
                        [sys.executable, "-m", f"{PKG}.node"],
                        cwd=REPO, env=victim_env,
                        stdout=subprocess.DEVNULL,
                        stderr=subprocess.STDOUT))

                window = NodeChurnWindow(
                    kill_victim, restart_victim, peer=victim,
                    kill_at_s=churn_spec["kill_at"],
                    restart_at_s=churn_spec["restart_at"])
                window.start(time.monotonic())
            before = kernel_launches(serve_url)
            try:
                row = drive(ep, args, chaos)
            finally:
                if window is not None:
                    window.stop()   # restores the victim if the run died
            # The kernels the measured run launched in the serve process.
            row["kernel_launches"] = {
                k: n - before.get(k, 0)
                for k, n in kernel_launches(serve_url).items()}
            if churn_spec is not None:
                # The churn contract's fleet-wide proxy: every message
                # parked while the victim was down must leave the
                # outboxes once it is back (at-least-once redelivery;
                # inbox msg_id dedup makes the client view exactly-once).
                wait_http(f"http://127.0.0.1:{victim_port}/healthz",
                          deadline_s=60.0)
                drained = outboxes_drained(ep.node_urls)
                row["churn"] = {**churn_spec, "peer": victim,
                                "churned": window.churned,
                                "outboxes_drained": drained}
                if not drained:
                    row.setdefault("failures", []).append(
                        "outboxes not drained after churn window "
                        "(messages still parked 90 s past restart)")
                    row["verdict"] = "fail"

            # Recovery probe: after the storm, the stack still answers.
            probe_ok = False
            try:
                with post(f"{serve_url}/api/generate",
                          {"model": args.config, "prompt": "probe",
                           "stream": False,
                           "options": {"num_predict": 4}},
                          timeout=120) as r:
                    probe_ok = bool(json.loads(r.read()).get("done"))
            except Exception as e:   # noqa: BLE001 — recorded, not fatal
                row.setdefault("failures", []).append(
                    f"post-run probe failed: {e}")
                row["verdict"] = "fail"
            row["post_run_probe_ok"] = probe_ok
            row.update(meta)
            rc = 0 if row["verdict"] == "pass" else 1
        except BaseException as e:
            row = error_row(e, meta)
            row["launcher_tail"] = (
                b"".join(tail)[-1500:].decode("utf-8", "replace"))
            raise
    finally:
        for p in respawned:
            p.terminate()
        launcher.terminate()
        try:
            launcher.wait(timeout=15)
        except subprocess.TimeoutExpired:
            launcher.kill()
        for p in respawned:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        if boot.get("quote_ckpt", {}).get("temporary"):
            shutil.rmtree(env["CKPT_DIR"], ignore_errors=True)
        if row and not args.no_row:
            path = write_row(row, args.out_dir)
            print(f"ledger row -> {path}", file=sys.stderr)
        if row:
            print(json.dumps(row), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
