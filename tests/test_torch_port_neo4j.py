"""The port's optional Neo4j export (``kg/neo4j_compat.py``) against the JAX
package's, on the CPU and with no ``neo4j`` package: a stub module placed
in ``sys.modules`` records what each export sends to the driver.

Both packages build their store from the same seeded annotations through
their own ``extract_structured`` and ``ingest_record``; both exports must
send the same constraints and the same MERGE statements with the same
parameters in the same order, and return the same write count. Without the
driver both raise the same ``RuntimeError``."""

import sys
import types

import numpy as np
import pytest

import jax

jax.config.update("jax_platforms", "cpu")

from camouflage_multimodal_tpu.kg import neo4j_compat as J_neo  # noqa: E402
from camouflage_multimodal_tpu.kg.normalize import extract_structured as j_extract  # noqa: E402
from camouflage_multimodal_tpu.kg.store import CamouflageKnowledgeStore as JStore  # noqa: E402
from camouflage_multimodal_tpu_torch.kg import neo4j_compat as T_neo  # noqa: E402
from camouflage_multimodal_tpu_torch.kg.normalize import extract_structured as t_extract  # noqa: E402
from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore as TStore  # noqa: E402

CATEGORIES = ("Fish", "Frog", "Owl", "Caterpillar")
# The constraint whose ``session.run`` the stub fails, as an older server
# would: the export must ignore it and go on.
FAILING_CONSTRAINT = "pattern_type"


def synthetic_annotations(seed=3, per_category=6):
    """(file name, annotation JSON) pairs in the reference's annotation
    schema, with organisms repeated across files (MERGE), vocabulary and
    free-text colours and textures."""
    colours = ("green", "brown", "sandy brown", "olive green", "gray", "blue-grey", "white")
    textures = ("rough", "smooth", "scaly", "gravel", "rocky", "vegetation", "fuzzy")
    places = ("an underwater coral reef", "a sandy seabed", "a forest floor of dark leaves",
              "desert rocks in shadow", "a tree trunk in dim light")
    patterns = ("Disruptive pattern", "spotted", "striped", "uniform", "None")
    levels = ("high", "medium", "low", "very high", "very low")
    rng = np.random.default_rng(seed)
    out = []
    for cat in CATEGORIES:
        for i in range(per_category):
            c, t, b = (rng.choice(colours, 2, replace=False), rng.choice(textures, 2, replace=False),
                       rng.choice(colours, 2, replace=False))
            out.append((f"{cat.lower()}_{i:03d}.json", {
                "object_name": f"{cat}{int(rng.integers(0, 3))}", "object_category": cat,
                "background_description": f"{rng.choice(places)} with {b[0]} and {b[1]} patches",
                "explanation": f"Its {c[0]} and {c[1]} body has a {t[0]}, {t[1]} surface",
                "camouflage_type": str(rng.choice(patterns)),
                "camouflage_presence": "Camouflage" if rng.random() < 0.7 else "None",
                "color_similarity": str(rng.choice(levels)),
                "texture_similarity": str(rng.choice(levels)),
                "contrast_difference": str(rng.choice(levels)),
                "camouflage_score": float(np.round(rng.random(), 3)),
                "confidence": float(np.round(0.5 + 0.5 * rng.random(), 3))}))
    return out


def build_store(store_cls, extract):
    store = store_cls()
    for name, obj in synthetic_annotations():
        store.ingest_record(extract(obj, name))
    return store


def stub_neo4j(fail_tx_after=None):
    """A ``neo4j`` module whose driver records every call. ``fail_tx_after``
    makes the transaction's n-th ``run`` raise."""
    log = {"driver": [], "database": [], "session": [], "tx": [], "execute_write": 0,
           "closed": 0}

    class Tx:
        def run(self, query, **params):
            if fail_tx_after is not None and len(log["tx"]) == fail_tx_after:
                raise ConnectionError("server went away")
            log["tx"].append((query, params))

    class Session:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def run(self, query):
            log["session"].append(query)
            if FAILING_CONSTRAINT in query:
                raise RuntimeError("constraint syntax not supported")

        def execute_write(self, fn):
            log["execute_write"] += 1
            return fn(Tx())

    class Driver:
        def session(self, database):
            log["database"].append(database)
            return Session()

        def close(self):
            log["closed"] += 1

    class GraphDatabase:
        @staticmethod
        def driver(uri, auth):
            log["driver"].append((uri, auth))
            return Driver()

    mod = types.ModuleType("neo4j")
    mod.GraphDatabase = GraphDatabase
    return mod, log


def export(neo, store, monkeypatch, **stub):
    """(write count or the exception raised, the stub's log)."""
    mod, log = stub_neo4j(**stub)
    monkeypatch.setitem(sys.modules, "neo4j", mod)
    try:
        writes = neo.export_to_neo4j(store, "bolt://localhost:7687", "neo4j", "secret",
                                     database="camouflage")
    except ConnectionError as err:
        writes = err
    return writes, log


def test_export_statements_match_jax(monkeypatch):
    jstore, tstore = build_store(JStore, j_extract), build_store(TStore, t_extract)
    j_writes, j_log = export(J_neo, jstore, monkeypatch)
    t_writes, t_log = export(T_neo, tstore, monkeypatch)
    assert t_log == j_log
    assert t_writes == j_writes
    # What the log must hold, counted from the port's store.
    assert t_writes == (len(tstore.organisms) + len(tstore.environments)
                        + len(tstore.assessments) + len(tstore.similarities)
                        + len(tstore.observations))
    assert len(t_log["session"]) == 8
    assert t_log["execute_write"] == 1 and t_log["closed"] == 1
    assert t_log["database"] == ["camouflage"]
    assert t_log["driver"] == [("bolt://localhost:7687", ("neo4j", "secret"))]
    links = sum(len(o["colors"]) + len(o["textures"]) + len(o["patterns"])
                for o in tstore.organisms.values())
    assert len(t_log["tx"]) == t_writes + links
    assert len(tstore.organisms) < len(tstore.observations)   # organisms merged


def test_export_closes_driver_when_a_write_fails(monkeypatch):
    """A failing write propagates, and both exports close the driver after
    the same statements."""
    j_err, j_log = export(J_neo, build_store(JStore, j_extract), monkeypatch, fail_tx_after=7)
    t_err, t_log = export(T_neo, build_store(TStore, t_extract), monkeypatch, fail_tx_after=7)
    assert isinstance(j_err, ConnectionError) and isinstance(t_err, ConnectionError)
    assert t_log == j_log
    assert len(t_log["tx"]) == 7 and t_log["closed"] == 1


def test_neo4j_available_and_missing_driver(monkeypatch):
    mod, _ = stub_neo4j()
    monkeypatch.setitem(sys.modules, "neo4j", mod)
    assert J_neo.neo4j_available() is T_neo.neo4j_available() is True
    # ``None`` in ``sys.modules`` makes ``import neo4j`` fail whether or not
    # a driver is installed.
    monkeypatch.setitem(sys.modules, "neo4j", None)
    assert J_neo.neo4j_available() is T_neo.neo4j_available() is False
    with pytest.raises(RuntimeError) as j_err:
        J_neo.export_to_neo4j(JStore(), "bolt://localhost:7687", "neo4j", "secret")
    with pytest.raises(RuntimeError) as t_err:
        T_neo.export_to_neo4j(TStore(), "bolt://localhost:7687", "neo4j", "secret")
    assert str(t_err.value) == str(j_err.value)
    assert "neo4j driver not installed" in str(t_err.value)
