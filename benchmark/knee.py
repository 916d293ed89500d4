"""The knee sweep of a serving mix: the mix on a configuration at each
given rate, one window each, in one process.

    python3 benchmark/knee.py --config cod10k-256 --traffic serve-steady \\
        --seconds 10 --seed 1 --rates 20 25 30 35 40 45 50

Per rate it prints the requests offered, answered (at all, and inside the
window), p50 and p95 (ms, from the due time) and the p95 of the requests
due in the first and in the second half of the window. The knee is the
highest rate at which at least 98 % of what was offered is answered and
the backlog does not grow: the second half's p95 stays within 1.25 times
the first half's.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import ROOT, load_json, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    name = f"{args.config}.{args.traffic}.knee"
    bench["workloads"] = [{"name": name, "config": args.config, "traffic": args.traffic,
                           "chips": 1, "why": "knee sweep"}]
    bench["end_to_end"] = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    mix = load_json(HERE / "traffic" / f"{args.traffic}.json")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for rate in args.rates:
            with open(Path(tmp) / f"{args.traffic}.json", "w") as f:
                json.dump(dict(mix, rate_per_s=rate), f)
            code, result, out = run(["--workload", name, "--seed", str(args.seed),
                                     "--seconds", str(args.seconds)], bench=bench,
                                    traffic_dir=Path(tmp))
            w = out.window
            row = {"rate_per_s": rate, "offered": w["offered"],
                   "answered": out.attempted - out.failed,
                   "answered_in_window": w["completed_in_window"],
                   "share": (out.attempted - out.failed) / w["offered"],
                   "tail_growth": w["p95_second_half_ms"] / max(w["p95_first_half_ms"], 1e-9),
                   "p50_ms": out.end_to_end["request_p50_ms"],
                   "p95_ms": out.end_to_end["request_p95_ms"],
                   "p95_first_half_ms": w["p95_first_half_ms"],
                   "p95_second_half_ms": w["p95_second_half_ms"],
                   "occupancy": w["requests"] / max(w["calls"], 1),
                   "late_ms_max": w["late_ms_max"], "correct": result["correct"]}
            rows.append(row)
            print(json.dumps({"knee_row": row}), flush=True)
    print(json.dumps({"knee": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
