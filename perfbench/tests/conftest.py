"""Fixtures of the benchmark's CPU tests: a checkout-shaped directory
holding a copy of ``perfbench/`` and a ``BENCHMARK.json`` with tiny cells
(two layers, widths cut) that the harness runs on the CPU; and the card
marker, for the one test that needs an NVIDIA card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_HF = {"bos_token_id": 1, "eos_token_id": 2, "hidden_size": 64,
           "intermediate_size": 128, "num_attention_heads": 4,
           "num_hidden_layers": 2, "num_key_value_heads": 2,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "vocab_size": 512,
           "max_position_embeddings": 1024}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card")


def tiny_config(moe: bool, quant: str) -> dict:
    hf = dict(TINY_HF)
    if moe:
        hf.update(num_local_experts=4, num_experts_per_tok=2)
    return {"name": "tiny-moe" if moe else "tiny", "source": "test",
            "hf_config": hf, "reduced": [], "quant": quant,
            "kv_quant": "int8",
            # From CPU readings at this size: sound runs 0.001 (int8) and
            # 0.017 (int4, top-2 of 4); the fp8 control 0.028; an
            # altered token 1 or more.
            "check": {"served_tokens": 60,
                      "max_logit_gap": 0.05 if moe else 0.01}}


def tiny_traffic(loop: str) -> dict:
    tr = json.loads((REPO / "perfbench" / "traffic"
                     / f"copilot_{'mix' if loop == 'open' else 'closed32'}.json"
                     ).read_text())
    tr.update(lead_in_s=1, drain_s=30, max_seq=1024, trace_s=1,
              warm_buckets=[128])
    if loop == "open":
        tr["rate_rps"] = 3.0
        tr["classes"][1]["prompt_tokens"] = {"dist": "uniform", "lo": 300,
                                             "hi": 500}
        tr["classes"][1]["output_tokens"] = {"dist": "uniform", "lo": 3,
                                             "hi": 6}
    else:
        tr["clients"] = 4
    tr["classes"][0]["output_tokens"] = {"dist": "uniform", "lo": 3, "hi": 8}
    return tr


def make_root(base: Path) -> Path:
    """A checkout-shaped directory: a copy of perfbench/, the repo's
    BENCHMARK.json, and tiny cells added the way a later PR adds one: new
    files and new entries only."""
    shutil.copytree(REPO / "perfbench", base / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for moe, quant in ((False, "int8"), (True, "int4")):
        cfg = tiny_config(moe, quant)
        path = f"perfbench/configs/{cfg['name']}.json"
        (base / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    for loop, name in (("open", "tiny_mix"), ("closed", "tiny_closed")):
        (base / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(tiny_traffic(loop)))
    for cfg, tr in (("tiny", "tiny_mix"), ("tiny-moe", "tiny_closed")):
        bench["workloads"].append({"name": f"{cfg}.{tr}", "config": cfg,
                                   "traffic": tr, "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(f"{cfg}.{tr}")
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))
