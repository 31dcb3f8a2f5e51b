"""Dev launcher of the port: boot the whole system on one machine —
the port of the repository's ``start_all.py``.

    python -m p2p_llm_chat_tpu_torch.start_all [--relay] [--backend torch]

The profile of start_all.sh (directory + 2 named nodes, Najy and Cannan,
+ 2 UIs) plus the port's LLM server and the optional relay:

    directory  :8080      (ADDR)
    serve      :11434     (SERVE_ADDR; FakeLLM by default, --backend torch
                           for the port's engine: on the card unless
                           SERVE_DEVICE=cpu is in the environment)
    relay      :4100      (RELAY_ADDR; --relay to enable)
    node Najy  :8081      (HTTP_ADDR)   + UI :8501
    node Cannan:8082      (HTTP_ADDR)   + UI :8502

Every child is a module of this package in a subprocess (``python -m
p2p_llm_chat_tpu_torch.<module>``); the chat-plane children see no card.
Health endpoints are polled instead of fixed sleeps, the serve child's
``/readyz`` gates the nodes and UIs, and Ctrl-C (or SIGTERM) tears the
whole tree down. This module imports no ``torch``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from p2p_llm_chat_tpu_torch.utils.env import env_float, env_int, env_or

PKG = "p2p_llm_chat_tpu_torch"
# The directory the children run from: the package's parent.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The chat plane is host code: its processes see no card.
NO_CARD = {"CUDA_VISIBLE_DEVICES": ""}


def wait_http(url: str, timeout: float = 30.0,
              procs: list | None = None) -> None:
    """Poll ``url`` until 200. When ``procs`` is given, a child that
    exits while we wait fails the boot IMMEDIATELY — a dead node must
    not burn the full readiness deadline before anyone notices (the
    e2e launcher path learned this at 64-peer scale: one bad port =
    4 minutes of silence)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        for name, p in procs or ():
            code = p.poll()
            if code is not None:
                raise RuntimeError(
                    f"{name} exited with code {code} while waiting for "
                    f"{url}")
        try:
            with urllib.request.urlopen(url, timeout=1):
                return
        except Exception:
            time.sleep(0.25)
    raise TimeoutError(f"service at {url} not ready after {timeout}s")


def check_port_ranges(n_users: int, node_base: int, ui_base: int,
                      dir_port: int, serve_port: int,
                      replicas: int = 0) -> None:
    """Fail at parse time when any service port ranges collide. With 2
    users the reference layout can't collide; at 64–128 peers the node
    and UI ranges are wide enough to plow into each other or into the
    serve/replica ports, and the failure mode without this check is a
    node that binds, a UI that doesn't, and a half-booted stack."""
    ranges = {
        "nodes": range(node_base, node_base + n_users),
        "UIs": range(ui_base, ui_base + n_users),
        "directory": range(dir_port, dir_port + 1),
        # replica mode: serve_port + 1..replicas are the engines
        "serve": range(serve_port, serve_port + 1 + max(0, replicas)),
    }
    names = list(ranges)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            ra, rb = ranges[a], ranges[b]
            if ra.start < rb.stop and rb.start < ra.stop:
                raise SystemExit(
                    f"port ranges collide: {a} [{ra.start},{ra.stop}) "
                    f"overlaps {b} [{rb.start},{rb.stop}) — move the "
                    "bases apart (--node-port-base/--ui-port-base/"
                    "--dir-port/--serve-port)")
    for name, r in ranges.items():
        if r.stop > 65536:
            raise SystemExit(f"{name} port range runs past 65535 "
                             f"([{r.start},{r.stop}))")
    # Ephemeral-range overlap is a WARNING, not an error: small runs
    # rarely collide, but at 64–128 peers ~2N booting processes make
    # outbound connections whose kernel-chosen source ports can land on
    # a service port that has not bound yet (observed: a random node
    # dying with EADDRINUSE mid-boot). Move the bases below the floor,
    # or reserve the ranges via ip_local_reserved_ports.
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            eph_lo, eph_hi = (int(x) for x in f.read().split())
    except (OSError, ValueError):
        return
    for name, r in ranges.items():
        if r.start <= eph_hi and eph_lo < r.stop and n_users >= 16:
            print(f"⚠️ {name} ports [{r.start},{r.stop}) overlap the "
                  f"kernel ephemeral range [{eph_lo},{eph_hi}] — at "
                  f"{n_users} peers a booting service can lose its port "
                  "to an outbound connection; use bases below "
                  f"{eph_lo} (or ip_local_reserved_ports)")


def spawn(name: str, module: str, env_extra: dict[str, str],
          procs: list[tuple[str, subprocess.Popen]]) -> subprocess.Popen:
    env = {**os.environ, **env_extra}
    p = subprocess.Popen([sys.executable, "-m", module], cwd=REPO_ROOT, env=env)
    procs.append((name, p))
    print(f"  started {name} (pid {p.pid})")
    return p


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--backend", default=env_or("SERVE_BACKEND", "fake"),
                    choices=["fake", "torch"],
                    help="LLM backend: fake | torch (default: fake; torch "
                         "serves on the card unless SERVE_DEVICE=cpu)")
    ap.add_argument("--relay", action="store_true", help="also start the relay daemon")
    ap.add_argument("--churn-tolerant", action="store_true",
                    help="keep the stack up when a NODE child dies — "
                         "loadgen peer-churn runs (the e2e bench's "
                         "--churn) SIGKILL nodes on purpose and respawn "
                         "them externally; any other child's death "
                         "still tears everything down")
    ap.add_argument("--users", default="Najy,Cannan",
                    help="comma-separated usernames (default mirrors start_all.sh)")
    ap.add_argument("--node-port-base", type=int,
                    default=env_int("NODE_PORT_BASE", 8081),
                    help="first node HTTP port (default 8081, reference layout)")
    ap.add_argument("--ui-port-base", type=int,
                    default=env_int("UI_PORT_BASE", 8501),
                    help="first UI port (default 8501, reference layout)")
    ap.add_argument("--dir-port", type=int,
                    default=env_int("DIR_PORT", 8080))
    ap.add_argument("--serve-port", type=int,
                    default=env_int("SERVE_PORT", 11434))
    ap.add_argument("--replicas", type=int,
                    default=env_int("SERVE_REPLICAS", 0),
                    help="replica-router serving: spawn N independent "
                         "full-stack serve processes on serve-port+1.. "
                         "plus the backpressure-aware router on "
                         "serve-port (0/1 = single engine, the default)")
    ap.add_argument("--prefill", type=int,
                    default=env_int("SERVE_PREFILL_REPLICAS", 0),
                    help="disaggregated serving: spawn N prefill-class "
                         "replicas — "
                         "new conversations chunk-prefill there, then "
                         "hand their KV to a decode replica over the "
                         "migration wire; combine with --decode")
    ap.add_argument("--decode", type=int,
                    default=env_int("SERVE_DECODE_REPLICAS", 0),
                    help="disaggregated serving: spawn M decode-class "
                         "replicas — they sample every token and never "
                         "run admission prefill work (their "
                         "decode_stall_ms stays ~0)")
    ap.add_argument("--autoscale", action="store_true",
                    default=env_int("SERVE_ROUTER_AUTOSCALE", 0) > 0,
                    help="replica mode only: arm the router's queue-"
                         "driven autoscaler — extra replicas spawn on "
                         "sustained backpressure (ports above the fixed "
                         "replica range) and retire through drain-as-"
                         "migration when the fleet idles")
    ap.add_argument("--relay-port", type=int,
                    default=env_int("RELAY_PORT", 4100))
    ap.add_argument("--boot-wave", type=int,
                    default=env_int("LOADGEN_BOOT_WAVE", 1),
                    help="node/UI boot wave size: spawn N nodes, then "
                         "health-gate the whole wave, then their UIs "
                         "(default 1 = the reference's strictly "
                         "sequential boot; 64–128-peer loadgen runs "
                         "use 8–16)")
    args = ap.parse_args()

    users = [u.strip() for u in args.users.split(",") if u.strip()]
    # Class-tagged fleet (--prefill/--decode, serve/disagg.py):
    # every class replica is an ordinary full-stack serve process whose
    # env carries SERVE_REPLICA_CLASS; the router discovers the pools
    # from the /readyz class field. Composes with --replicas (those
    # spawn as mixed — the compatibility pool).
    n_class = max(0, args.prefill) + max(0, args.decode)
    mixed = args.replicas if args.replicas >= 2 or n_class else 0
    fixed_replicas = mixed + n_class
    if fixed_replicas == 1:
        raise SystemExit("a routed fleet needs >= 2 replicas; use "
                         "--prefill/--decode/--replicas so the class "
                         "pools plus mixed total at least 2")
    # Autoscaled replicas spawn on ports just above the fixed range —
    # reserve up to the autoscaler's max so a scale-up can't collide
    # with a node/UI port. A class fleet scales PER CLASS: two pools,
    # each with a hard-bounded 4x-ceiling port range (the slack absorbs
    # crash-leaked slots — serve/disagg.build_class_autoscaler).
    scale_room = ((env_int("SERVE_ROUTER_AUTOSCALE_MAX", 4)
                   * (8 if n_class else 1))
                  if args.autoscale and fixed_replicas else 0)
    check_port_ranges(len(users), args.node_port_base, args.ui_port_base,
                      args.dir_port, args.serve_port,
                      fixed_replicas + scale_room)
    procs: list[tuple[str, subprocess.Popen]] = []

    def shutdown(*_, exit_code: int = 0):
        print("\nshutting down...")
        for name, p in reversed(procs):
            if p.poll() is None:
                p.terminate()
        for _, p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        sys.exit(exit_code)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    print("🚀 starting the p2p-llm-chat stack (PyTorch port)")
    try:
        dir_url = f"http://127.0.0.1:{args.dir_port}"
        serve_url = f"http://127.0.0.1:{args.serve_port}"
        spawn("directory", f"{PKG}.directory",
              {"ADDR": f"127.0.0.1:{args.dir_port}", **NO_CARD}, procs)
        if fixed_replicas >= 2:
            # Replica-router serving (serve/router.py): N independent
            # full-stack engines on successive ports, the
            # backpressure-aware router on the main serve port — the
            # UIs' OLLAMA_URL points at the router unchanged. On one
            # machine this is the dev/demo profile (fake backend, or
            # tiny configs on CPU); production runs one replica per
            # card and points SERVE_ROUTER_UPSTREAMS at them. With
            # --prefill/--decode the fleet is class-tagged
            # (disaggregation, serve/disagg.py): prefill replicas take new
            # conversations' admission work, decode replicas take the
            # streams after the KV handoff, mixed ones (--replicas)
            # remain the compatibility pool.
            roles = (["prefill"] * max(0, args.prefill)
                     + ["decode"] * max(0, args.decode)
                     + ["mixed"] * mixed)
            upstreams = []
            for i, role in enumerate(roles):
                rport = args.serve_port + 1 + i
                upstreams.append(f"http://127.0.0.1:{rport}")
                spawn(f"serve-{role}-{i}", f"{PKG}.serve",
                      {"SERVE_ADDR": f"127.0.0.1:{rport}",
                       "SERVE_BACKEND": args.backend,
                       # Explicit per-replica role: a mixed replica
                       # must not inherit a class from the launcher
                       # environment any more than a replica may
                       # inherit router/lockstep mode flags.
                       "SERVE_REPLICA_CLASS": role,
                       "SERVE_ROUTER_UPSTREAMS": "",
                       "SERVE_COORDINATOR": ""}, procs)
            # The router is the port's serve entry with
            # SERVE_ROUTER_UPSTREAMS: it builds no engine.
            router_env = {"SERVE_ADDR": f"127.0.0.1:{args.serve_port}",
                          "SERVE_ROUTER_UPSTREAMS": ",".join(upstreams),
                          "SERVE_REPLICA_CLASS": "",
                          "SERVE_COORDINATOR": ""}
            if args.autoscale:
                # Autoscaled replicas are subprocesses of the ROUTER
                # (serve/router.py ProcessReplicaSpawner): they inherit
                # its environment, so the backend choice must ride
                # along, and their ports sit just above the fixed
                # replica range (reserved by check_port_ranges). The
                # class counts switch the router to the per-class
                # autoscaler (serve/disagg.py).
                router_env.update({
                    "SERVE_ROUTER_AUTOSCALE": "1",
                    "SERVE_ROUTER_AUTOSCALE_PORT_BASE":
                        str(args.serve_port + 1 + fixed_replicas),
                    "SERVE_BACKEND": args.backend,
                    "SERVE_PREFILL_REPLICAS": str(max(0, args.prefill)),
                    "SERVE_DECODE_REPLICAS": str(max(0, args.decode)),
                })
            spawn("serve-router", f"{PKG}.serve", router_env, procs)
        else:
            spawn("serve", f"{PKG}.serve",
                  {"SERVE_ADDR": f"127.0.0.1:{args.serve_port}",
                   "SERVE_BACKEND": args.backend}, procs)
        relay_addrs = ""
        if args.relay:
            # The relay publishes its fresh multiaddr (identity is per-start)
            # to a file; nodes get it as RELAY_ADDRS so they actually hold
            # reservations — a relay no node can use is dead config.
            addr_file = os.path.join(tempfile.mkdtemp(prefix="p2pchat-relay-"),
                                     "relay.maddr")
            spawn("relay", f"{PKG}.relay",
                  {"RELAY_ADDR": f"127.0.0.1:{args.relay_port}",
                   "RELAY_ADDR_FILE": addr_file, **NO_CARD}, procs)
            deadline = time.time() + 15
            while time.time() < deadline and not os.path.exists(addr_file):
                time.sleep(0.1)
            if not os.path.exists(addr_file):
                raise TimeoutError("relay did not publish its multiaddr")
            with open(addr_file) as f:
                relay_addrs = f.read().strip()
            shutil.rmtree(os.path.dirname(addr_file), ignore_errors=True)
            print(f"  relay multiaddr: {relay_addrs}")
        wait_http(f"{dir_url}/healthz", procs=procs)
        # Big-model boots (an 8B checkpoint streamed onto the card,
        # quantized, and the warmup's graph captures) take minutes;
        # SERVE_WAIT_S widens the readiness budget. /readyz (not
        # /healthz): the engine warms up in the BACKGROUND, so liveness
        # arrives minutes before the compiled programs do — launching
        # the UIs at /healthz put the first suggestions' TTFT behind
        # warmup compiles. wait_http treats /readyz's 503-warming as
        # not-ready (urlopen raises on it) and keeps polling. A torch
        # serve child that cannot reach the card raises and exits: the
        # boot fails here, with no fallback.
        serve_wait = env_float(
            "SERVE_WAIT_S", 300.0 if args.backend != "fake" else 30.0)
        # procs: a serve crash at boot (bad port, OOM mid-restore) must
        # fail NOW, not after burning SERVE_WAIT_S (up to 30 min for 8B).
        wait_http(f"{serve_url}/readyz", timeout=serve_wait, procs=procs)

        dht_seed = ""

        def boot_node(i: int, user: str) -> None:
            node_env = {
                **NO_CARD,
                "MYNAMEIS": user,
                "HTTP_ADDR": f"127.0.0.1:{args.node_port_base + i}",
                "DIRECTORY_URL": dir_url,
            }
            if relay_addrs:
                node_env["RELAY_ADDRS"] = relay_addrs
            if dht_seed:
                # Chain every later node's DHT off the first node, so a
                # launched deployment resolves peers through a directory
                # outage out of the box (node.py lookup ladder rung 3).
                node_env["DHT_BOOTSTRAP"] = dht_seed
            spawn(f"node-{user}", f"{PKG}.node", node_env, procs)

        def boot_ui(i: int, user: str) -> None:
            spawn(f"ui-{user}", f"{PKG}.ui", {
                **NO_CARD,
                "NODE_HTTP": f"http://127.0.0.1:{args.node_port_base + i}",
                "OLLAMA_URL": serve_url,
                "UI_ADDR": f"127.0.0.1:{args.ui_port_base + i}",
            }, procs)

        def grab_dht_seed(node_port: int) -> str:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{node_port}/me",
                        timeout=5) as r:
                    return json.loads(r.read()).get("dht_addr", "")
            except Exception:  # noqa: BLE001 — DHT stays optional
                return ""

        wave = max(1, args.boot_wave)
        first = 1 if wave > 1 and len(users) > 1 else 0
        if first:
            # Node 0 boots ALONE so every later wave (including the rest
            # of wave 1) can chain its DHT off it — the same bootstrap
            # topology the sequential path builds.
            boot_node(0, users[0])
            wait_http(f"http://127.0.0.1:{args.node_port_base}/healthz",
                      timeout=60, procs=procs)
            dht_seed = grab_dht_seed(args.node_port_base)
            boot_ui(0, users[0])
        for w0 in range(first, len(users), wave):
            batch = list(enumerate(users))[w0:w0 + wave]
            for i, user in batch:
                boot_node(i, user)
            for i, user in batch:
                # 60 s: a loaded host (64-node boots alongside a busy
                # serve) can starve a fresh interpreter's startup well
                # past 30 s; a crashed child fails the whole boot now,
                # not at the deadline.
                wait_http(
                    f"http://127.0.0.1:{args.node_port_base + i}/healthz",
                    timeout=60, procs=procs)
            if not dht_seed:
                dht_seed = grab_dht_seed(args.node_port_base + batch[0][0])
            for i, user in batch:
                boot_ui(i, user)
    except Exception as e:  # noqa: BLE001 — never leave orphaned children
        print(f"❌ startup failed: {e}; cleaning up")
        shutdown(exit_code=1)

    print("\n✅ all up:")
    for i, user in enumerate(users):
        print(f"   {user}: UI http://127.0.0.1:{args.ui_port_base + i}  "
              f"node http://127.0.0.1:{args.node_port_base + i}")
    print(f"   LLM API {serve_url}  directory {dir_url}\n")
    print("Ctrl-C to stop.")

    while True:
        alive = []
        for name, p in procs:
            code = p.poll()
            if code is None:
                alive.append((name, p))
            elif args.churn_tolerant and name.startswith("node-"):
                # Forgotten, not fatal: the churn window owns this
                # node's lifecycle now (its respawn is the window's
                # child, not ours).
                print(f"⚠️ {name} exited with {code}; continuing "
                      "(--churn-tolerant)")
            else:
                print(f"⚠️ {name} exited with {code}; shutting down")
                shutdown(exit_code=1)
        procs[:] = alive
        time.sleep(1)


if __name__ == "__main__":
    sys.exit(main())
