"""Loadgen: open-loop scenario-mix traffic with a per-request SLO ledger
— the port's copy of p2p_llm_chat_tpu/loadgen (host code: it imports
neither ``torch`` nor the reference package).

The chat plane's load subsystem:

- scenarios.py — the scenario registry (mix weights, payload builders
  against the real wire paths, per-scenario SLO targets);
- driver.py    — the seeded open-loop Poisson driver and per-request
  trace records;
- report.py    — the SLO ledger: percentiles, goodput, shed/error
  taxonomy, pass/fail verdict, durable ``E2E_r0N.json`` rows;
- chaos.py     — failpoints armed *under* load plus the degradation-
  contract checks (fast sheds with Retry-After, no hung streams,
  recovery after disarm);
- stub.py      — the in-process stub server the test suite drives.

``p2p_llm_chat_tpu_torch/tools/e2e_bench.py`` is the operator CLI over
all of it.
"""

from .chaos import (ChaosWindow, ChurnWindow, NodeChurnWindow,
                    check_churn_delivery, check_contracts)
from .driver import Arrival, LoadDriver, TraceRecord, build_schedule
from .report import (build_ledger, error_row, fetch_timelines, percentile,
                     write_row)
from .scenarios import (REGISTRY, SLO, Endpoints, Scenario, Step,
                        default_mix, parse_mix)
from .stub import StubServer

__all__ = [
    "Arrival", "ChaosWindow", "ChurnWindow", "Endpoints", "LoadDriver",
    "NodeChurnWindow",
    "REGISTRY",
    "SLO", "Scenario", "Step", "StubServer", "TraceRecord",
    "build_ledger", "build_schedule", "check_churn_delivery",
    "check_contracts", "default_mix",
    "error_row", "fetch_timelines", "parse_mix", "percentile", "write_row",
]
