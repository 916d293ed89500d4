"""One run of one cell: resolve the cell by name, run its driver, read the
per-layer metrics, print the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's sizes in ``configs/<config>.json``, the traffic mix in
``traffic/<mix>.json``, the driver the mix names in ``drivers/<kind>.py``
and each per-layer metric's reader in ``metrics/<metric>.py``. A new cell,
mix, configuration or metric is a new file and a new entry: no file here
changes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "camouflage_multimodal_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files resolved."""

    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def resolve(bench: Dict[str, Any], workload: str, traffic_dir: Path = HERE / "traffic") -> Cell:
    """The cell named ``workload`` with its configuration, mix and metrics.
    A per-layer metric without a ``workloads`` list is read in every cell
    that reports the end-to-end metric it moves."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(traffic_dir / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m["workloads"] if "workloads" in m] + \
        [m for m in bench["per_layer"] if "workloads" not in m and m["moves"] in names]
    return Cell(workload, config, traffic, e2e, per_layer)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    # What the per-layer readers read besides the trace: counts of the
    # traced window's work ("images", "steps", "calls"), the real node
    # counts of its images or records, counter deltas.
    window: Dict[str, Any] = field(default_factory=dict)


class Context:
    """What a driver gets: the run's arguments, the cell's files, the
    device, a scratch directory under ``TMPDIR`` and the tracer."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float, tmp: str) -> None:
        from tracing import Tracer

        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.trace, self.device = seed, trace, device
        # A traced run profiles a shorter window: the readers normalise per
        # item, and a trace of the whole window would take minutes to read.
        self.seconds = min(seconds, cell.traffic.get("trace_seconds", seconds)) if trace \
            else seconds
        self.t_start, self.tmp = t_start, tmp
        self.tracer = Tracer(trace)
        self.setup_s: Optional[float] = None
        self.phases: List[Tuple[str, float]] = []
        # name → function(the driver's callable) → the callable to use: the
        # control and the fault tests put another path in the program's place.
        self.wraps: Dict[str, Callable[[Callable], Callable]] = {}

    def wrapped(self, name: str, fn: Callable) -> Callable:
        wrap = self.wraps.get(name)
        return fn if wrap is None else wrap(fn)

    def generator(self, stream: int = 0):
        """A generator on the device, seeded from ``--seed`` and ``stream``."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1000003 + stream) % (2 ** 63 - 1))
        return g

    def phase(self, name: str) -> None:
        """Mark the end of a part of set-up (printed on standard error)."""
        self.phases.append((name, time.perf_counter() - self.t_start))

    def fixed_generator(self, seed: int):
        """A generator on the device with a fixed seed: the scenes every
        seed of a mix shares, so that the seed changes the order of the
        work and not its amount."""
        import torch

        return torch.Generator(device=self.device).manual_seed(seed)

    def setup_done(self) -> None:
        """Set-up ends here; the measured window starts next."""
        self.setup_s = time.perf_counter() - self.t_start
        self.phase("setup_done")

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (nearest rank) of ``values``; inf counts."""
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1, int(-(-q * len(ordered) // 100)) - 1))
    return ordered[k]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv: Optional[List[str]] = None, t_start: Optional[float] = None,
        device: Optional[str] = None, bench: Optional[Dict[str, Any]] = None,
        traffic_dir: Path = HERE / "traffic",
        patch: Optional[Callable[[Context], None]] = None) -> Tuple[int, Optional[Dict], Any]:
    """Run a cell; returns (exit code, the result or None, the driver's
    :class:`Outcome` or None). The tests call it with another ``bench`` and
    ``traffic_dir`` (small sizes) and a ``device`` ("cpu"), which skips the
    look for a card. ``patch(ctx)`` runs
    before the driver: the fault tests break the timed path with it."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cell = resolve(bench, args.workload, traffic_dir)
    wl = {w["name"]: w for w in bench["workloads"]}[args.workload]

    import torch

    if device is None:
        need = int(wl.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"error: {args.workload} needs {need} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2, None, None
        device = "cuda"
    dev = torch.device(device)
    # The configurations state float32: no TF32 in matrix products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py",
                         f"bench_driver_{cell.traffic['driver']}")
    tmp = tempfile.mkdtemp(prefix="cmt-bench-")
    try:
        ctx = Context(cell, args.seed, args.seconds, bool(args.trace), dev, t_start, tmp)
        ctx.phase("imports")
        if patch is not None:
            patch(ctx)
        outcome: Outcome = driver.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {found}: the port's benchmark loads no JAX "
              "and nothing of the JAX package", file=sys.stderr)
        return 3, None, None

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics: Dict[str, Dict[str, Any]] = {}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    if args.trace:
        tr = ctx.tracer.trace
        window = dict(outcome.window, trace=tr, config=cell.config, traffic=cell.traffic)
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
    else:
        values = dict(outcome.end_to_end, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": all(c.ok for c in outcome.checks) and bool(outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if args.trace:
        result["breakdown"] = ctx.tracer.trace.breakdown()
    # The numbers compared, each beside its limit, last.
    result["checks"] = {c.name: {"value": float(c.value), "limit": float(c.limit)}
                        for c in outcome.checks}
    print("setup phases (s from process start): "
          + ", ".join(f"{n} {t:.3f}" for n, t in ctx.phases), file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} = {float(c.value)!r} limit {float(c.limit)!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0, result, outcome
