"""One run of one cell: set-up, lead-in, the measured window, the drain,
the readers of the cell's metrics, and the served-token check.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration file (``configs`` entry's
``file``), its traffic file ``perfbench/traffic/<traffic>.json`` and each
metric's reader ``perfbench/metrics/<metric>.py`` (a ``read(run)`` that
returns a number, or None where it finds nothing to read).

The window is driven from this process on the port's engine directly
(``TorchEngine.generate_stream``, into the scheduler's ``submit``): an
open loop sends each request at its due time; a closed loop keeps
``clients`` requests in flight. Load continues after the window closes
until every request counted in it has finished or the drain limit has
passed, so the last counted requests see the same load as the first.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import counting, kernels, traffic as gen
from .stats import percentile

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "p2p_llm_chat_tpu")

# The main path (ROADMAP.md): paged int8 KV, prefix cache, chunked
# prefill, fused decode, speculation off. A traffic file's "engine" and a
# configuration file's "engine" override these.
ENGINE = dict(num_slots=32, page_size=64, kv_quant=True, kv_mode="paged",
              prefix_cache=True, prefill_chunk=256, decode_fuse_max=4,
              spec_k=0, attn_impl="gather", queue_timeout_s=60.0)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict              # the configuration file
    traffic: dict             # the traffic file
    metrics: list             # BENCHMARK.json metric entries of this cell

    @property
    def hf(self) -> dict:
        return self.config["hf_config"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{entry['traffic']}.json")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if _reports(m, name)]
    return Cell(name, entry, config, traffic, metrics)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Record:
    """One request as the client saw it (monotonic seconds)."""

    req: gen.Request
    prompt_ids: list
    due: float
    send: float = math.nan
    deltas: list = field(default_factory=list)       # (t, text)
    done: float = math.nan
    error: str = ""
    counted: bool = False
    stats: object = None
    trace_id: str = ""
    gen_req: object = None
    late: bool = False        # counted, and not finished by the drain limit

    @property
    def first(self) -> float:
        return self.deltas[0][0] if self.deltas else math.inf

    @property
    def text(self) -> str:
        return "".join(d for _, d in self.deltas)

    @property
    def finished(self) -> bool:
        return not math.isnan(self.done)


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    model: counting.Model
    seconds: float
    t_start: float            # process start (monotonic)
    t_open: float
    t_close: float
    records: list
    counters: dict            # "open" / "close" -> metrics_snapshot
    slots: int
    cached_prefix: str        # the template registered in the prefix cache
    spans: dict = field(default_factory=dict)    # trace id -> spans
    anchor: float = 0.0       # epoch s - monotonic s of the span store
    trace: object = None
    slice: tuple = ()         # (start, end) monotonic of the traced slice
    drain_s: float = 60.0

    def counted(self, ttft_only: bool = False) -> list:
        return [r for r in self.records
                if r.counted and (r.req.ttft or not ttft_only)]

    def ttft_ms(self) -> list:
        """Suggestions counted in the window: due (open loop) or send
        (closed) to the first streamed delta; a miss is +inf."""
        out = []
        for r in self.counted(ttft_only=True):
            ok = r.deltas and not r.error and r.first - r.due <= (
                self.seconds + self.drain_s)
            out.append((r.first - r.due) * 1e3 if ok else math.inf)
        return out

    def within_ms(self, limit_ms: float) -> float | None:
        """The share (%) of the counted suggestions whose first token came
        within ``limit_ms`` of due; a miss is outside."""
        v = self.ttft_ms()
        return 100.0 * sum(x <= limit_ms for x in v) / len(v) if v else None

    def failed(self) -> int:
        """Counted requests that failed, were shed, or had no answer by
        the drain limit."""
        return sum(1 for r in self.counted()
                   if r.error or r.late or not r.deltas)

    def miss_ms(self) -> float:
        """What +inf reads as in a result: the longest wait the window and
        the drain can observe."""
        return (self.seconds + self.drain_s) * 1e3

    def cached_tokens(self, r: Record) -> int:
        pre = self.cached_prefix
        return 1 + len(pre) if pre and r.req.prompt.startswith(pre) else 0


def model_of(hf: dict) -> counting.Model:
    from .reference.weights import Shape
    s = Shape.from_hf(hf)
    return counting.Model(hidden=s.hidden, intermediate=s.intermediate,
                          layers=s.layers, heads=s.heads,
                          kv_heads=s.kv_heads, head_dim=s.head_dim,
                          vocab=s.vocab, experts=s.experts,
                          top_k=s.experts_per_tok)


def prompt_ids(prompt: str) -> list:
    """The byte tokenizer's ids with BOS (256), worked out here."""
    return [256] + list(prompt.encode("utf-8"))


class Load:
    """Sends the traffic into the engine and records what streams back."""

    def __init__(self, engine, traffic: dict, seed: int, t0: float,
                 segments: list, traced: bool) -> None:
        self.engine = engine
        self.traffic = traffic
        self.seed = seed
        self.t0 = t0
        self.segments = segments
        self.traced = traced
        self.records: list = []
        self.stop = threading.Event()
        self._threads: list = []
        self._mu = threading.Lock()

    def _request(self, r: gen.Request, due: float) -> Record:
        from p2p_llm_chat_tpu_torch.serve.backend import (GenerateOptions,
                                                          GenerateRequest,
                                                          RequestStats)
        rec = Record(req=r, prompt_ids=prompt_ids(r.prompt), due=due,
                     stats=RequestStats())
        opts = GenerateOptions(max_tokens=r.max_tokens, temperature=0.0,
                               seed=r.index)
        kw = {}
        if self.traced:
            rec.trace_id = uuid.UUID(int=random.Random(
                f"{self.seed}:{r.index}").getrandbits(128)).hex
            kw = dict(trace_id=rec.trace_id, trace_sampled=True)
        rec.gen_req = GenerateRequest(prompt=r.prompt, options=opts, **kw)
        with self._mu:
            self.records.append(rec)
        return rec

    def _consume(self, rec: Record) -> None:
        try:
            rec.send = time.monotonic()
            for delta in self.engine.generate_stream(rec.gen_req, rec.stats):
                rec.deltas.append((time.monotonic(), delta))
        except Exception as e:  # noqa: BLE001 — a failed request is a miss
            rec.error = f"{type(e).__name__}: {e}"
        rec.done = time.monotonic()

    def _open(self) -> None:
        for r in gen.open_schedule(self.traffic, self.seed,
                                   self.segments):
            due = self.t0 + r.due_s
            while not self.stop.is_set():
                wait = due - time.monotonic()
                if wait <= 0:
                    break
                self.stop.wait(min(wait, 0.05))
            if self.stop.is_set():
                return
            rec = self._request(r, due)
            t = threading.Thread(target=self._consume, args=(rec,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _client(self, stream, lock) -> None:
        while not self.stop.is_set():
            with lock:
                r = next(stream)
            self._consume(self._request(r, time.monotonic()))

    def start(self) -> None:
        if self.traffic["loop"] == "open":
            targets = [(self._open, ())]
        else:
            stream, lock = gen.closed_stream(self.traffic, self.seed), \
                threading.Lock()
            targets = [(self._client, (stream, lock))] * int(
                self.traffic["clients"])
        for fn, args in targets:
            t = threading.Thread(target=fn, args=args, daemon=True)
            t.start()
            self._threads.append(t)

    def finish(self, timeout: float) -> None:
        self.stop.set()
        end = time.monotonic() + timeout
        for t in list(self._threads):
            t.join(max(0.0, end - time.monotonic()))


def _log(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def _activities(dev) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _profile(sched, seconds: float) -> tuple:
    """torch.profiler over ``seconds`` of the serving loop: (the profiler,
    (start, end) monotonic). It starts and stops on the scheduler's loop
    thread, between iterations, where the slice's ends are read."""
    prof = torch.profiler.profile(activities=_activities(sched.device),
                                  record_shapes=True)
    ends: list = []

    def start() -> None:
        prof.start()
        ends.append(time.monotonic())

    def stop() -> None:
        ends.append(time.monotonic())
        prof.stop()

    sched.run_on_loop(start)
    time.sleep(max(0.0, ends[0] + seconds - time.monotonic()))
    sched.run_on_loop(stop)
    return prof, tuple(ends)


def sample(records: list, seed: int, served_tokens: int) -> list:
    """The requests the reference checks: the longest finished one, then
    others drawn from the seed until ``served_tokens`` served tokens."""
    ok = [r for r in records if r.finished and not r.error]
    if not ok:
        return []
    rng = random.Random(f"{seed}:sample")
    longest = max(ok, key=lambda r: (len(r.prompt_ids) + r.req.max_tokens,
                                     r.req.index))
    rest = [r for r in ok if r is not longest]
    rng.shuffle(rest)
    out, n = [longest], longest.req.max_tokens
    for r in rest:
        if n >= served_tokens:
            break
        out.append(r)
        n += r.req.max_tokens
    return out


def served(r: Record) -> tuple[list, bool]:
    """(the served ids, whether the answer is whole and agrees with the
    stream): the context the engine returned must start with the prompt's
    ids, hold ``max_tokens`` more, and decode to what streamed."""
    ctx = list(r.stats.context or [])
    P = len(r.prompt_ids)
    ids = ctx[P:]
    ok = (ctx[:P] == r.prompt_ids and len(ids) == r.req.max_tokens
          and all(0 <= i < 256 for i in ids)
          and bytes(ids).decode("utf-8", "replace") == r.text)
    return ids, ok


def check(run: Run, seed: int, device, free, control: bool = False) -> dict:
    """The served-token comparison: {name: (value, limit)}. Every counted
    request must have been answered (``requests_failed`` 0) and whole;
    the sampled served tokens' widest gap must stay under the limit. With
    ``control`` also ``control_gap``: the same widest gap read for the
    tokens the configuration's control (``check.control``: ``fp8``
    activations, or ``int4`` weights) puts first, under the same limit."""
    from .reference.check import widest_gaps
    from .reference.model import Reference
    from .reference.weights import Shape
    cfg = run.cell.config
    counted = [r for r in run.counted()
               if r.finished and not r.error and not r.late]
    bad = sum(not served(r)[1] for r in counted)
    failed = (run.failed(), 0)
    picks = sample(counted, seed, int(cfg["check"]["served_tokens"]))
    free()
    t = time.monotonic()
    ref = Reference(Shape.from_hf(run.cell.hf), cfg["quant"],
                    cfg.get("kv_quant") == "int8", seed, device)
    if not picks:
        _log({"reference": "no finished request to check"})
        return {"max_logit_gap": (1e9, cfg["check"]["max_logit_gap"]),
                "answers_not_whole": (bad, 0), "requests_failed": failed}
    lower = cfg["check"].get("control", "fp8")
    widest = widest_gaps(ref, [(r.prompt_ids, served(r)[0]) for r in picks],
                         ("bf16", lower) if control else ())
    _log({"reference": {"requests": len(picks),
                        "served_tokens": sum(r.req.max_tokens for r in picks),
                        "seconds": round(time.monotonic() - t, 3),
                        "widest_gaps": sorted(widest["served_all"])[-10:]}})
    gap = max(widest["served"])
    out = {"max_logit_gap": (gap, cfg["check"]["max_logit_gap"]),
           "answers_not_whole": (bad, 0), "requests_failed": failed}
    if control:
        out["control_gap"] = (max(widest[lower]),
                              cfg["check"]["max_logit_gap"])
        _log({"gaps": {k: v for k, v in widest.items() if k.endswith("_all")}})
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", root: Path = ROOT,
        rate: float | None = None, control: bool = False) -> dict:
    """One run; returns the result line's object."""
    from . import program
    cell = load_cell(cell_name, trace, root)
    tr = dict(cell.traffic)
    if rate is not None:
        tr["rate_rps"] = rate
    dev = torch.device(device)
    chips = int(cell.entry.get("chips", 1))
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < chips):
        raise SystemExit(f"the cell needs {chips} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    marks = {"start": time.monotonic()}
    cfg = cell.config
    tree = program.params(cell.hf, cfg["quant"], seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks["weights"] = time.monotonic()
    settings = dict(ENGINE, **cfg.get("engine", {}), **tr.get("engine", {}))
    settings["max_seq"] = int(tr["max_seq"])
    config = program.model_config(cfg["name"], cell.hf, settings["max_seq"])
    engine = program.engine(tree, config, settings, dev)
    store, anchor = None, 0.0
    if trace:
        from p2p_llm_chat_tpu_torch.obs.trace import TraceStore
        store = TraceStore(max_traces=1 << 20)
        anchor = time.time() - time.monotonic()
        engine.set_trace_store(store)
    marks["engine"] = time.monotonic()
    engine.warmup(tuple(tr["warm_buckets"]), background=False)
    if trace:
        # The profiler's first start initialises its tracer for seconds,
        # with the loop held: pay it here, not in the window.
        warm = torch.profiler.profile(activities=_activities(dev))
        engine.scheduler.run_on_loop(warm.start)
        engine.scheduler.run_on_loop(warm.stop)
        del warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks["warmup"] = time.monotonic()
    lead, drain = float(tr["lead_in_s"]), float(tr["drain_s"])
    t0 = time.monotonic()
    t_open, t_close = t0 + lead, t0 + lead + seconds
    load = Load(engine, tr, seed, t0,
                    [lead, seconds, drain + float(tr.get("trace_s", 0)) + 5],
                    trace)
    load.start()
    counters = {}
    time.sleep(max(0.0, t_open - time.monotonic()))
    counters["open"] = engine.metrics_snapshot()
    bad = forbidden_modules()
    _log({"setup": {"start_s": round(marks["start"] - t_start, 3),
                    "weights_s": round(marks["weights"] - marks["start"], 3),
                    "engine_s": round(marks["engine"] - marks["weights"], 3),
                    "warmup_s": round(marks["warmup"] - marks["engine"], 3),
                    "lead_in_s": round(time.monotonic() - marks["warmup"], 3)}})
    time.sleep(max(0.0, t_open + seconds / 5 - time.monotonic()))
    counters["fifth"] = engine.metrics_snapshot()
    time.sleep(max(0.0, t_close - time.monotonic()))
    counters["close"] = engine.metrics_snapshot()
    _log({"backlog": {k: counters[k]["serve_queue_depth"]
                      for k in ("open", "fifth", "close")}})
    for r in list(load.records):
        r.counted = t_open <= r.due < t_close
    deadline = t_close + drain
    while time.monotonic() < deadline:
        if all(r.finished for r in load.records if r.counted):
            break
        time.sleep(0.05)
    for r in load.records:
        r.late = r.counted and not r.finished
    if trace:
        # The traced slice: the same load, right after the window's
        # requests have drained, so the profiler's stop (seconds with the
        # interpreter held) touches no request counted in the window.
        prof, slice_ends = _profile(engine.scheduler, float(tr["trace_s"]))
    load.finish(timeout=30.0)
    engine.stop()
    load.finish(timeout=10.0)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    records = list(load.records)
    runinfo = Run(cell=cell, model=model_of(cell.hf), seconds=seconds,
                  t_start=t_start, t_open=t_open, t_close=t_close,
                  records=records, counters=counters,
                  slots=int(settings["num_slots"]),
                  cached_prefix=(program.SUGGEST_PREFIX
                                 if settings["prefix_cache"] else ""),
                  drain_s=drain)
    breakdown = None
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        from .trace import breakdown as make_breakdown, export_and_parse
        runinfo.spans = {r.trace_id: store.get(r.trace_id) for r in records
                         if r.trace_id}
        runinfo.anchor = anchor
        runinfo.slice = slice_ends
        t = time.monotonic()
        runinfo.trace, size = export_and_parse(prof)
        _log({"trace": {"bytes": size, "events": len(runinfo.trace.events),
                        "slice_s": runinfo.slice[1] - runinfo.slice[0],
                        "parse_s": round(time.monotonic() - t, 3)}})
        del prof
        device_info["busy_s"] = runinfo.trace.busy_s()
        device_info["window_s"] = runinfo.trace.window_s
        breakdown = make_breakdown(runinfo.trace)
        _log({"qmm_counted_s": {
            op: kernels.coverage(runinfo.trace, runinfo.model, ops,
                                 runinfo.slots)
            for op, ops in (("decode", ("tick",)),
                            ("prefill", ("admit", "chunk")))}})
    metrics = {}
    for m in cell.metrics:
        v = reader(m["name"], root)(runinfo)
        if v is None:
            continue
        if math.isinf(v):
            v = runinfo.miss_ms()
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    v = runinfo.ttft_ms()
    if v:
        _log({"ttft_ms": {"n": len(v), "p50": percentile(v, 50),
                          "p95": percentile(v, 95), "max": max(v),
                          "mean": sum(v) / len(v),
                          "within_1s_pct": runinfo.within_ms(1e3),
                          "within_4s_pct": runinfo.within_ms(4e3)}})
    counted = runinfo.counted()

    def free() -> None:
        nonlocal engine, tree
        engine = tree = load.engine = None
        runinfo.trace = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    checks = check(runinfo, seed, dev, free, control)
    judged = {k: c for k, c in checks.items() if k != "control_gap"}
    correct = all(v <= lim for v, lim in judged.values())
    bad = bad or forbidden_modules()
    if bad:
        raise SystemExit(f"loaded modules of JAX or the JAX package: {bad}")
    out = {"correct": bool(correct), "attempted": len(counted),
           "failed": runinfo.failed(), "metrics": metrics,
           "device": device_info}
    if control:
        # The control in the program's place: its tokens through the
        # same test, which it has to fail.
        judged["max_logit_gap"] = checks["control_gap"]
        out["control_correct"] = all(v <= lim for v, lim in judged.values())
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
