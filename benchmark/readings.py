"""The readings a limit is set from: the program's checks on many seeds,
the control's (the reference in the program's place, one precision down)
and each planted fault's, in one process at the cell's own size.

    python3 benchmark/readings.py --workload <cell> --seconds 3 \\
        --program 1 2 3 ... --control 4 5 6 [--fault half_batch 7 8 9]

Each run prints its result line; the last line is a JSON summary: for
each number compared, the largest the program read and the smallest the
control and each fault read.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import ROOT, load_json, load_module, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--fault", action="append", nargs="+", default=[],
                   help="a fault's name, then its seeds")
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    kind = load_json(HERE / "traffic" / f"{cell['traffic']}.json")["driver"]
    driver = load_module(HERE / "drivers" / f"{kind}.py", f"bench_driver_{kind}")
    plans = [("program", None, args.program), ("control", driver.control, args.control)]
    plans += [(f"fault:{f[0]}", driver.FAULTS[f[0]], [int(s) for s in f[1:]]) for f in args.fault]
    summary = {}
    for mode, patch, seeds in plans:
        for seed in seeds:
            code, result, _ = run(["--workload", args.workload, "--seed", str(seed),
                                   "--seconds", str(args.seconds)], patch=patch)
            if code != 0:
                print(json.dumps({"mode": mode, "seed": seed, "exit": code}), flush=True)
                continue
            for name, c in result["checks"].items():
                slot = summary.setdefault(name, {})
                key = "program_max" if mode == "program" else f"{mode}_min"
                pick = max if mode == "program" else min
                slot[key] = pick(slot.get(key, c["value"]), c["value"])
                slot.setdefault(f"{mode}_values", []).append(c["value"])
            print(json.dumps({"mode": mode, "seed": seed, "correct": result["correct"],
                              "checks": {k: c["value"] for k, c in result["checks"].items()}}),
                  flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
