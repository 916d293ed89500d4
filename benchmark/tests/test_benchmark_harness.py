"""The harness on the CPU at small sizes: names resolve to files, a cell is
added by adding files, the result line has its shape, nothing loads JAX,
and every fault a cell can have turns ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import tiny
from harness import FORBIDDEN, HERE, ROOT, load_json, load_module, resolve

BENCH = load_json(ROOT / "BENCHMARK.json")
KINDS = {"offline": "cod10k-352.offline-b16", "serve": tiny.SERVE_CELL,
         "train": tiny.TRAIN_CELL}


def test_every_name_resolves_to_its_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert load_json(ROOT / c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = resolve(BENCH, w["name"])
        driver = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py", "d")
        assert callable(driver.run) and callable(driver.control) and driver.FAULTS
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"]), c["name"]
        for limit in cell.traffic["limits"]:
            assert isinstance(cell.traffic["limits"][limit], (int, float))
    for m in BENCH["per_layer"]:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", "r")
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A copy of the benchmark gains a mix, a metric and a cell through new
    files and new entries only, and runs the new cell."""
    repo = tmp_path / "repo"
    shutil.copytree(HERE, repo / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tiny.tiny_bench()
    mix = load_json(tiny.FIXTURES / "tiny-offline.json")
    (repo / "benchmark" / "traffic" / "offline-b2.json").write_text(json.dumps(dict(mix, batch=2)))
    (repo / "benchmark" / "metrics" / "images_traced.offline.py").write_text(
        "def read(w):\n    return float(w['images']) or None\n")
    bench["workloads"].append({"name": "cod10k-352.offline-b2", "config": "cod10k-352",
                               "traffic": "offline-b2", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "images_traced.offline", "unit": "images",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "images_per_s",
                               "workloads": ["cod10k-352.offline-b2"]})
    for c in bench["configs"]:
        c["file"] = "benchmark/tests/fixtures/" + tiny.CONFIGS[c["name"]]
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(repo / 'benchmark')!r}, {str(ROOT)!r}]
        from harness import run
        code, result, _ = run(["--workload", "cod10k-352.offline-b2", "--seed", "3",
                               "--seconds", "1", "--trace", "1"], device="cpu")
        assert code == 0 and result["correct"], result
        assert result["metrics"]["images_traced.offline"]["value"] > 0
    """)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_its_shape(kind, trace):
    code, result = tiny.run_tiny(KINDS[kind], seconds=1.5, trace=trace)
    assert code == 0, result
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    cell = resolve(tiny.tiny_bench(), KINDS[kind], tiny.FIXTURES)
    device = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    if trace:
        assert {"busy_s", "window_s"} <= set(device)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name, m in result["metrics"].items():
        assert m["value"] > 0 and isinstance(m["unit"], str), name
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


FAULT_CASES = [(kind, name) for kind in sorted(KINDS)
               for name in load_module(HERE / "drivers" / f"{kind}.py", "d").FAULTS]


@pytest.mark.parametrize("kind,fault", FAULT_CASES)
def test_each_fault_turns_correct_false(kind, fault):
    driver = load_module(HERE / "drivers" / f"{kind}.py", f"d_{kind}")
    code, result = tiny.run_tiny(KINDS[kind], seconds=1.5, patch=driver.FAULTS[fault])
    assert code == 0
    assert result["correct"] is False, result["checks"]


def test_no_jax_is_loaded():
    """A whole run at small size, in a process of its own, then the top-level
    name of every loaded module compared whole with the forbidden ones."""
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(HERE / 'tests')!r}]
        import tiny
        for cell in {sorted(KINDS.values())!r}:
            code, result = tiny.run_tiny(cell, seconds=1)
            assert code == 0 and result["correct"], cell
        from harness import FORBIDDEN
        tops = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(tops & set(FORBIDDEN)))
        print("camouflage_multimodal_tpu_torch" in tops)
    """)
    env = dict(os.environ, USE_FLAX="0")
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=900, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    found, port_loaded = done.stdout.strip().splitlines()[-2:]
    assert found == "[]" and port_loaded == "True"
    assert "camouflage_multimodal_tpu" in FORBIDDEN and "camouflage_multimodal_tpu_torch" not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {*FORBIDDEN, "camouflage_multimodal_tpu_torch"}, (path, tops)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_control_fails_on_the_card(kind):
    """The reference in the program's place with TF32 products reads as not
    correct; TF32 exists only on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control's lower precision (TF32) exists only on a CUDA card")
    from harness import run

    driver = load_module(HERE / "drivers" / f"{kind}.py", f"d_{kind}")
    code, result, _ = run(["--workload", KINDS[kind], "--seed", "9", "--seconds", "2"],
                          bench=tiny.tiny_bench(), traffic_dir=tiny.FIXTURES,
                          patch=driver.control)
    assert code == 0 and result["correct"] is False, result["checks"]
