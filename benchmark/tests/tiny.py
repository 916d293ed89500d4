"""The benchmark at a size a CPU test can hold: a copy of
``BENCHMARK.json`` whose configurations are ``fixtures/tiny-64.json`` and
whose mixes are the ``fixtures/tiny-*.json`` files."""

from __future__ import annotations

import copy
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FIXTURES = HERE / "fixtures"
# The serving cells run the program's predictor, which serves 256² images.
CONFIGS = {"cod10k-352": "tiny-64.json", "cod10k-256": "tiny-256.json"}
MIXES = {"offline-b16": "tiny-offline", "serve-steady": "tiny-serve",
         "serve-overload": "tiny-serve", "train-fusion": "tiny-train"}


# The serving and training drivers have no cell in BENCHMARK.json (their runs
# spread too widely, PERF.md §7); the tests give each one, with its metrics.
SERVE_CELL = "cod10k-256.serve-steady"
TRAIN_CELL = "cod10k-256.train-fusion"
SERVE_METRICS = [
    {"name": n, "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
     "workloads": [SERVE_CELL]} for n in ("request_p50_ms", "request_p95_ms")]
SERVE_LAYERS = [
    {"name": n, "unit": u, "better": b, "source": "device_trace", "layer": "serving",
     "moves": "request_p95_ms", "workloads": [SERVE_CELL]}
    for n, u, b in (("batch_occupancy.overload", "requests", "higher"),
                    ("predict_ms.overload", "ms", "lower"),
                    ("rg_build_host_ms.overload", "ms", "lower"),
                    ("device_idle.overload", "%", "lower"))]
TRAIN_METRICS = [{"name": "train_step_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                  "source": "host_clock", "workloads": [TRAIN_CELL]}]
TRAIN_LAYERS = [
    {"name": n, "unit": u, "better": b, "source": "device_trace", "layer": "trainer",
     "moves": "train_step_ms", "workloads": [TRAIN_CELL]}
    for n, u, b in (("launches_per_step.train", "launches", "lower"),
                    ("optimizer_host_ms.train", "ms", "lower"),
                    ("mfu.train", "%", "higher"), ("device_idle.train", "%", "lower"))]


def tiny_bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "cod10k-256", "source": "tests",
                             "file": "benchmark/configs/cod10k-256.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"] += [
        {"name": SERVE_CELL, "config": "cod10k-256", "traffic": "serve-steady", "chips": 1,
         "why": "serving"},
        {"name": TRAIN_CELL, "config": "cod10k-256", "traffic": "train-fusion", "chips": 1,
         "why": "training"}]
    bench["end_to_end"] += SERVE_METRICS + TRAIN_METRICS
    bench["per_layer"] += SERVE_LAYERS + TRAIN_LAYERS
    for c in bench["configs"]:
        c["file"] = os.path.relpath(FIXTURES / CONFIGS[c["name"]], ROOT)
    for w in bench["workloads"]:
        w["traffic"] = MIXES[w["traffic"]]
    return bench


def run_tiny(workload: str, seed: int = 5, seconds: float = 2.0, trace: int = 0, patch=None):
    from harness import run

    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    return run(argv, device="cpu", bench=tiny_bench(), traffic_dir=FIXTURES, patch=patch)[:2]
