"""The port's public surface against the JAX package's, on the CPU.

Every name a JAX package ``__init__`` exports (the top level with its lazy
names, ``core``, ``kg``, ``models``, ``train``, ``utils``) resolves on the
port's package, and every public top-level function and class of each JAX
module has a counterpart in the port's module of the same name. The only
exceptions are written down once, in ``PORT_RENAMES`` and ``BY_DESIGN``, so
that a JAX name left without a counterpart cannot go unnoticed. The names
are read from the JAX sources with ``ast``, then resolved on both packages.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

import jax

jax.config.update("jax_platforms", "cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "camouflage_multimodal_tpu"
PORT_PKG = "camouflage_multimodal_tpu_torch"
PACKAGES = ("", "core", "kg", "models", "train", "utils")

# JAX names whose port counterpart has another name, in PyTorch's idiom:
# "module.name" → the port's "module.name", or None where the JAX object is
# state that ``nn.Module`` and ``torch.optim`` hold in the port, or a
# recorder whose part ``torch.profiler`` plays (the port's spans are
# ``core.profiling.annotate`` ranges, read from its traces). Parameters
# follow the same idiom (``fit(use_scan=)`` is ``fit(device_resident=)``,
# ``variables=`` / ``state=`` are a module's own state). The JAX
# connectivity pass's run-structured path and its dispatcher map to the
# port's one path, which gives the same labels.
PORT_RENAMES = {
    "train.state.TrainState": None,
    "core.profiling.StageTimer": None,
    "core.profiling.trace": None,
    "train.state.make_adamw_tx": "train.state.make_adamw",
    "train.state.make_adam_l2_tx": "train.state.make_adam_l2",
    "ops.pallas_slic.pallas_slic_assign": "ops.slic.slic_assign",
    "ops.pallas_attention.pallas_multihead_attention": "ops.attention.fused_mha",
    "ops.pallas_attention.pallas_multihead_attention_trainable": "ops.attention.fused_mha",
    "ops.connectivity.enforce_label_connectivity_runs":
        "ops.connectivity.enforce_label_connectivity",
    "ops.connectivity.enforce_label_connectivity_batched":
        "ops.connectivity.enforce_label_connectivity",
}
# JAX modules without a module of the same name in the port, and why.
BY_DESIGN = {
    "core.runtime": "XLA's persistent compile cache; the CUDA kernels cache their "
                    "builds by a hash of source and flags (core/kernels.py)",
    "ops.pallas_slic": "kernel B1, csrc/slic_assign.cu behind ops.slic.slic_assign",
    "ops.pallas_attention": "kernels B2 and B3, csrc/fused_mha*.cu behind "
                            "ops.attention.fused_mha",
}


# Entry scripts whose port is a module of another name or place.
ENTRY_PORTS = {"bench.py": "bench", "__graft_entry__.py": "graft_entry"}


def _modules(root):
    """Dotted names (relative to the package) of every module under root."""
    out = []
    for path in sorted((REPO / root).rglob("*.py")):
        rel = path.relative_to(REPO / root).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _source(pkg, module):
    base = REPO / pkg / pathlib.Path(*module.split(".")) if module else REPO / pkg
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def _full(pkg, module):
    return f"{pkg}.{module}" if module else pkg


def _exported(module):
    """Public names a JAX package ``__init__`` binds (imports, assignments,
    definitions, ``__all__``), and the keys of its lazy ``__getattr__``
    table."""
    tree = ast.parse(_source(JAX_PKG, module).read_text())
    names, lazy = set(), set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                names.update(ast.literal_eval(node.value))
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Dict):
                    lazy.update(k.value for k in sub.keys if isinstance(k, ast.Constant))
    public = {n for n in names if not n.startswith("_") and n != "__getattr__"}
    return public, lazy


def _public_defs(module):
    """Public top-level functions and classes of a JAX module."""
    tree = ast.parse(_source(JAX_PKG, module).read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def _resolve(dotted):
    """The port's object at "module.name" (the module part may be empty)."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(_full(PORT_PKG, module)), name)


def test_rename_map_is_written_down_and_resolves():
    """Every rename names a JAX object that exists and a port object that
    exists; every by-design module is a JAX module without a port twin."""
    jax_modules, port_modules = set(_modules(JAX_PKG)), set(_modules(PORT_PKG))
    for jax_name, port_name in PORT_RENAMES.items():
        module, _, name = jax_name.rpartition(".")
        assert name in _public_defs(module), jax_name
        if port_name is not None:
            assert callable(_resolve(port_name)), port_name
    assert set(BY_DESIGN) == jax_modules - port_modules


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_every_jax_name(package):
    """Each name the JAX package exports resolves on the port's package of
    the same name; the JAX ones resolve too, so the list read from the
    source is the list the package exports."""
    names, lazy = _exported(package)
    assert names | lazy, package
    jax_pkg = importlib.import_module(_full(JAX_PKG, package))
    port_pkg = importlib.import_module(_full(PORT_PKG, package))
    for name in sorted(names | lazy):
        getattr(jax_pkg, name)
        if callable(getattr(jax_pkg, name)):
            assert callable(getattr(port_pkg, name)), name
        else:
            getattr(port_pkg, name)
    if package == "":
        assert len(lazy) == 11 and {"load_config", "default_config"} <= names


def test_top_level_lazy_names_point_at_the_port():
    import camouflage_multimodal_tpu_torch as cm
    from camouflage_multimodal_tpu_torch import api, pipeline

    assert cm.detect_camouflage is api.detect_camouflage
    assert cm.MultimodalPredictor is api.MultimodalPredictor
    assert cm.evaluate_directory is api.evaluate_directory
    assert cm.RegionGraphPipeline is pipeline.RegionGraphPipeline
    for name in sorted(_exported("")[1]):
        assert getattr(cm, name).__module__.startswith(PORT_PKG + "."), name
    with pytest.raises(AttributeError):
        cm.no_such_name  # noqa: B018


@pytest.mark.parametrize("module", [m for m in _modules(JAX_PKG) if m not in BY_DESIGN])
def test_module_has_every_jax_function_and_class(module):
    """Every public top-level function and class of the JAX module has a
    counterpart in the port's module of the same name, or a written
    rename."""
    port = importlib.import_module(_full(PORT_PKG, module))
    missing = []
    for name in _public_defs(module):
        dotted = f"{module}.{name}" if module else name
        if dotted in PORT_RENAMES:
            continue
        if not hasattr(port, name):
            missing.append(name)
    assert not missing, (module, missing)


def test_by_design_modules_names_are_covered():
    """The kernel modules' public functions map to the port's wrappers."""
    for module in ("ops.pallas_slic", "ops.pallas_attention"):
        for name in _public_defs(module):
            assert f"{module}.{name}" in PORT_RENAMES, (module, name)


def test_package_import_stays_light():
    """``import camouflage_multimodal_tpu_torch`` loads neither the API nor
    the pipelines, models or kernels (nor torch)."""
    code = (
        "import sys\n"
        f"import {PORT_PKG}\n"
        f"print(sorted(m for m in sys.modules if m.startswith('{PORT_PKG}')))\n"
        "print('torch' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded, torch_loaded = res.stdout.strip().splitlines()
    loaded = ast.literal_eval(loaded)
    for heavy in ("api", "pipeline", "models", "core.kernels", "ops"):
        assert f"{PORT_PKG}.{heavy}" not in loaded, (heavy, loaded)
    assert torch_loaded == "False"


def _entry_scripts():
    return sorted([f"scripts/{p.name}" for pattern in ("*.py", "*.sh")
                   for p in (REPO / "scripts").glob(pattern)] + list(ENTRY_PORTS))


def _port_of(script):
    """The port module's dotted name for a JAX entry script."""
    if script in ENTRY_PORTS:
        return f"{PORT_PKG}.{ENTRY_PORTS[script]}"
    return f"{PORT_PKG}.scripts.{pathlib.Path(script).stem}"


@pytest.mark.parametrize("script", _entry_scripts())
def test_entry_script_has_a_port_or_needs_the_reference(script):
    """Each JAX entry script (``scripts/*.py``, ``scripts/*.sh``,
    ``bench.py``, ``__graft_entry__.py``) has a port module with ``main``
    (or with ``entry`` and ``dryrun_multichip``). The quality and fidelity
    scripts and the full-chain demo, which read COD10K, the annotations and
    the reference's recorded outputs, are ported too: their runs on that
    data wait for it, not their code."""
    port = importlib.import_module(_port_of(script))
    if script == "__graft_entry__.py":
        assert callable(port.entry) and callable(port.dryrun_multichip)
    else:
        assert callable(port.main), script
