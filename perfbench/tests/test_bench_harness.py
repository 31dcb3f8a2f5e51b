"""The harness on the CPU: cells found by name, misses in the percentiles,
the window's rate, the JAX check, whole runs of tiny cells with the timed
path sound and with it broken, and the exits without a card."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from perfbench import harness, traffic as gen
from perfbench.stats import percentile, spread

from .conftest import REPO, make_root


def _record(cls="suggestion", due=0.0, deltas=(), error="", counted=True):
    r = gen.Request(index=0, cls=cls, prompt="x", max_tokens=len(deltas),
                    due_s=0.0, ttft=cls == "suggestion")
    rec = harness.Record(req=r, prompt_ids=[256, 120], due=due,
                         deltas=list(deltas), error=error, counted=counted)
    rec.send, rec.done = due, due + 1.0
    return rec


def _run(records, seconds=10.0):
    cell = harness.Cell("c", {}, {"hf_config": {}}, {}, [])
    return harness.Run(cell=cell, model=None, seconds=seconds, t_start=0.0,
                       t_open=100.0, t_close=100.0 + seconds,
                       records=records, counters={}, slots=32,
                       cached_prefix="")


def test_failed_and_undrained_requests_are_misses():
    ok = [_record(due=100.0 + i, deltas=[(100.1 + i, "a"), (100.2 + i, "b")])
          for i in range(17)]
    failed = _record(due=101.0, error="RuntimeError: boom")
    never = _record(due=102.0)                       # no first token
    long = _record(cls="long", due=103.0, deltas=[(103.5, "a")])
    run = _run(ok + [failed, never, long])
    ttft = run.ttft_ms()
    assert len(ttft) == 19 and ttft.count(math.inf) == 2
    assert math.isinf(percentile(ttft, 95))
    assert percentile(ttft, 50) == pytest.approx(100.0)
    read = harness.reader("ttft_p50_ms")
    assert read(run) == pytest.approx(100.0)
    assert math.isinf(read(_run([ok[0], failed, never])))
    assert harness.reader("ttft_within_4s_pct")(run) == pytest.approx(
        100.0 * 17 / 19)
    assert run.failed() == 2


def test_the_window_rate_counts_every_token_streamed_inside_it():
    lead_in = _record(due=95.0, counted=False,
                      deltas=[(99.9, "ab"), (100.0, "cd"), (104.0, "e")])
    inside = _record(due=101.0, deltas=[(101.5, "fgh"), (109.99, "i"),
                                        (110.0, "j"), (111.0, "k")])
    run = _run([lead_in, inside], seconds=10.0)
    # "cd", "e", "fgh", "i": 7 tokens in [100, 110).
    assert harness.reader("output_tok_s")(run) == pytest.approx(0.7)
    assert harness.reader("itl_p95_ms")(run) == pytest.approx(
        percentile([8490.0, 10.0, 1000.0], 95))


def test_percentile_and_spread_arithmetic():
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile([5], 95) == 5
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_a_cell_is_added_by_new_files_and_entries_only(tiny_root, tmp_path):
    root = make_root(tmp_path / "c")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "perfbench/configs/tiny.json").read_text())
    cfg["name"] = "tiny-b"
    (root / "perfbench/configs/tiny-b.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "perfbench/traffic/tiny_mix.json").read_text())
    tr["rate_rps"] = 1.5
    (root / "perfbench/traffic/slow_mix.json").write_text(json.dumps(tr))
    (root / "perfbench/metrics/answers_n.py").write_text(
        "def read(run):\n    return float(len(run.counted()))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-b", "source": "t", "reduced": [],
                             "file": "perfbench/configs/tiny-b.json",
                             "why": "t"})
    bench["workloads"].append({"name": "tiny-b.slow_mix", "config": "tiny-b",
                               "traffic": "slow_mix", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "answers_n", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "client", "moves": "output_tok_s",
                               "workloads": ["tiny-b.slow_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("tiny-b.slow_mix", trace=True, root=root)
    assert cell.config["name"] == "tiny-b"
    assert cell.traffic["rate_rps"] == 1.5
    assert "answers_n" in [m["name"] for m in cell.metrics]
    read = harness.reader("answers_n", root)
    assert read(_run([_record(), _record()])) == 2.0
    after = {p: p.read_bytes() for p in before}
    assert after == before                      # no file edited
    assert "answers_n" not in [m["name"] for m in harness.load_cell(
        "tiny.tiny_mix", trace=True, root=root).metrics]


def test_benchmark_json_names_what_each_cell_reads():
    """Every cell's files and readers exist; every cell reports setup_s,
    another end-to-end metric and a per-layer one; a metric's cells each
    report the end-to-end metric it moves."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = [w["name"] for w in bench["workloads"]]
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        assert (REPO / configs[w["config"]]["file"]).is_file()
        assert (REPO / f"perfbench/traffic/{w['traffic']}.json").is_file()
    reports = {c: {n for n, m in e2e.items()
                   if c in m.get("workloads", cells)} for c in cells}
    for c, names in reports.items():
        assert "setup_s" in names and len(names) >= 2, c
    read_by = {c: 0 for c in cells}
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert (REPO / f"perfbench/metrics/{m['name']}.py").is_file()
        for c in m.get("workloads", cells):
            assert c in cells
            if m in bench["per_layer"]:
                assert m["moves"] in reports[c], (m["name"], c)
                read_by[c] += 1
    assert all(read_by.values()), read_by


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("jaxtyping", "p2p_llm_chat_tpu_torch.x", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "p2p_llm_chat_tpu",
                        types.ModuleType("p2p_llm_chat_tpu"))
    assert harness.forbidden_modules() == ["jax.numpy", "p2p_llm_chat_tpu"]


def _tiny(root, cell, trace=False, control=False, seed=2 ** 31 + 77):
    return harness.run(cell, seed, 4.0, trace, t_start=time.monotonic(),
                       device="cpu", root=root, control=control)


@pytest.mark.parametrize("cell", ["tiny.tiny_mix", "tiny-moe.tiny_closed"])
def test_a_tiny_cell_runs_correct_on_the_cpu(tiny_root, cell):
    out = _tiny(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"ttft_p50_ms", "ttft_within_4s_pct",
                                   "itl_p95_ms", "output_tok_s", "setup_s"}
    assert out["checks"]["requests_failed"] == {"value": 0, "limit": 0}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_a_traced_tiny_run_reads_the_host_side_metrics(tiny_root):
    out = _tiny(tiny_root, "tiny.tiny_mix", trace=True)
    assert out["correct"]
    # The CPU has no device events: the device readers find nothing.
    assert {"gen_lag_p99_ms", "queue_wait_p95_ms", "queue_wait_p95_ms.mix",
            "decode_rows_mean"} <= set(out["metrics"])
    assert "mfu.decode" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert "device_ops" in out["breakdown"]


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every fifth sampled token
    becomes the next printable byte."""
    from p2p_llm_chat_tpu_torch.serve import scheduler
    orig = scheduler.BatchScheduler._append_token
    count = [0]

    def altered(self, slot, row, tok):
        count[0] += 1
        if count[0] % 5 == 0:
            tok = 32 + (tok - 31) % 95
        return orig(self, slot, row, tok)
    monkeypatch.setattr(scheduler.BatchScheduler, "_append_token", altered)


@pytest.mark.parametrize("cell", ["tiny.tiny_mix", "tiny-moe.tiny_closed"])
def test_an_altered_token_makes_the_run_incorrect(tiny_root, monkeypatch,
                                                  cell):
    _alter_tokens(monkeypatch)
    out = _tiny(tiny_root, cell)
    gap = out["checks"]["max_logit_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"]


def test_a_decode_step_that_leaves_the_pool_unchanged_is_incorrect(
        tiny_root, monkeypatch):
    """A step that returns its state unchanged: no decoded token's k/v
    ever lands in the pool, so later tokens attend without them. On the
    dense tiny cell it reads 0.38 against the limit 0.01; the tiny MoE
    cell's short answers move it too little to test (0.03-0.43)."""
    from p2p_llm_chat_tpu_torch.models import llama
    monkeypatch.setattr(llama, "write_decode", lambda *a, **k: None)
    monkeypatch.setattr(llama, "write_decode_burst", lambda *a, **k: None)
    out = _tiny(tiny_root, "tiny.tiny_mix")
    gap = out["checks"]["max_logit_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"]


def test_the_control_fails_the_limit_a_sound_run_meets(tiny_root):
    out = _tiny(tiny_root, "tiny.tiny_mix", control=True)
    c = out["checks"]
    assert out["correct"]
    assert c["max_logit_gap"]["value"] <= c["max_logit_gap"]["limit"]
    assert c["control_gap"]["limit"] == c["max_logit_gap"]["limit"]
    assert c["control_gap"]["value"] > c["control_gap"]["limit"]
    assert out["control_correct"] is False


def test_the_int4_weight_control_fails_the_limit(tmp_path):
    """A configuration whose ``check.control`` is ``int4`` (Mistral's): the
    reference with the int8 weights in int4 groups, put in the program's
    place, comes out not correct."""
    root = make_root(tmp_path / "c")
    path = root / "perfbench/configs/tiny.json"
    cfg = json.loads(path.read_text())
    cfg["check"]["control"] = "int4"
    path.write_text(json.dumps(cfg))
    out = _tiny(root, "tiny.tiny_mix", control=True)
    c = out["checks"]
    assert out["correct"]
    assert c["control_gap"]["value"] > c["control_gap"]["limit"]
    assert out["control_correct"] is False


def test_a_shed_request_makes_the_run_incorrect(tiny_root, monkeypatch):
    """Every fourth request is shed where the engine takes it: the
    answers that do come are right, and the run is not correct."""
    from p2p_llm_chat_tpu_torch.serve.engine import TorchEngine
    from p2p_llm_chat_tpu_torch.serve.backend import OverloadError
    orig = TorchEngine.generate_stream
    count = [0]

    def shedding(self, req, stats=None):
        count[0] += 1
        if count[0] % 4 == 0:
            raise OverloadError("server at capacity", retry_after_s=1.0)
        return orig(self, req, stats)
    monkeypatch.setattr(TorchEngine, "generate_stream", shedding)
    out = _tiny(tiny_root, "tiny.tiny_mix")
    c = out["checks"]
    assert c["max_logit_gap"]["value"] <= c["max_logit_gap"]["limit"]
    assert c["requests_failed"]["value"] == out["failed"] > 0
    assert not out["correct"]


def test_run_exits_without_a_card_and_prints_no_result(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "mistral-7b.copilot_mix", "--seed", str(2 ** 31 + 5),
           "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
    # A checkout holding only BENCHMARK.json and perfbench/: no program.
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from perfbench import harness; harness.run("
            "'mistral-7b.copilot_mix', 1, 1, False, t_start=time.monotonic(),"
            " device='cpu')")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True)
    assert p.returncode != 0 and "p2p_llm_chat_tpu_torch" in p.stderr


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "mistral-7b.copilot_closed32", "--seed", str(2 ** 31 + 99),
           "--seconds", "10", "--trace", "0"]
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
