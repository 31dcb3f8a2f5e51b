"""The control of the served-token check, on the card at a cell's size.

For each seed, one short run of the cell (its own traffic and load,
``--seconds`` of window), then the reference over the sampled requests
in one pass: in float32, and one step below what the configuration
states (its ``check.control``: ``fp8``, every matmul's activations in
float8_e4m3fn, the step below bfloat16; ``int4``, an int8
configuration's weights in int4 groups).
Prints per seed the program's widest gap (a sound run's reading) and the
control's (the gap of the token the control puts first), each run's
``correct`` and the control's verdict under the same test and limit
(``control_correct``), then the largest of the first gaps, the smallest
of the second, and whether the control came out not correct on every
seed. Exits non-zero where a sound run is not correct or the control is.

    python3 perfbench/control.py --workload <cell> --seconds 10 --seeds 1 2 3
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    rows = []
    for seed in args.seeds:
        out = harness.run(args.workload, seed, args.seconds, False,
                          t_start=time.monotonic(), device=args.device,
                          control=True)
        c = out["checks"]
        rows.append({"seed": seed, "served_gap": c["max_logit_gap"]["value"],
                     "control_gap": c["control_gap"]["value"],
                     "limit": c["max_logit_gap"]["limit"],
                     "correct": out["correct"],
                     "control_correct": out["control_correct"],
                     "requests_failed": c["requests_failed"]["value"],
                     "answers_not_whole": c["answers_not_whole"]["value"]})
        print(json.dumps(rows[-1]), flush=True)
    sound = all(r["correct"] for r in rows)
    caught = not any(r["control_correct"] for r in rows)
    print(json.dumps({"workload": args.workload,
                      "lower": max(r["served_gap"] for r in rows),
                      "upper": min(r["control_gap"] for r in rows),
                      "sound_runs_correct": sound,
                      "control_not_correct_on_every_seed": caught}))
    return 0 if sound and caught else 1


if __name__ == "__main__":
    sys.exit(main())
