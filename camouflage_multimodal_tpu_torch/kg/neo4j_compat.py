"""Optional export of the knowledge-graph store into a Neo4j server: the
port's copy of ``camouflage_multimodal_tpu/kg/neo4j_compat.py``.

The in-process store (:mod:`.store`) is the supported backend. For users
who still want the graph in Neo4j, :func:`export_to_neo4j` writes a
:class:`CamouflageKnowledgeStore` through the reference's MERGE-based,
constraint-guarded pattern (``ingest_to_neo4j.py:200-403``), statement for
statement and parameter for parameter as the JAX package does. The ``neo4j``
driver is not a requirement of the port: it is imported only inside the
functions, and without it the export raises ``RuntimeError``.
"""

from __future__ import annotations

from camouflage_multimodal_tpu_torch.kg.store import CamouflageKnowledgeStore


def neo4j_available() -> bool:
    try:
        import neo4j  # noqa: F401

        return True
    except ImportError:
        return False


_CONSTRAINTS = [
    "CREATE CONSTRAINT organism_name IF NOT EXISTS FOR (o:Organism) REQUIRE o.name IS UNIQUE",
    "CREATE CONSTRAINT color_name IF NOT EXISTS FOR (c:Color) REQUIRE c.name IS UNIQUE",
    "CREATE CONSTRAINT texture_name IF NOT EXISTS FOR (t:Texture) REQUIRE t.name IS UNIQUE",
    "CREATE CONSTRAINT pattern_type IF NOT EXISTS FOR (p:Pattern) REQUIRE p.type IS UNIQUE",
    "CREATE CONSTRAINT observation_id IF NOT EXISTS FOR (oc:ObservationContext) REQUIRE oc.id IS UNIQUE",
    "CREATE CONSTRAINT assessment_id IF NOT EXISTS FOR (ca:CamouflageAssessment) REQUIRE ca.id IS UNIQUE",
    "CREATE CONSTRAINT similarity_id IF NOT EXISTS FOR (sm:SimilarityMetric) REQUIRE sm.id IS UNIQUE",
    "CREATE CONSTRAINT lighting_condition IF NOT EXISTS FOR (lc:LightingCondition) REQUIRE lc.condition IS UNIQUE",
]


def _write_store(tx, store: CamouflageKnowledgeStore) -> int:
    """Every MERGE of the export, in the JAX package's order: each organism
    with its colours, textures and patterns, then the environments,
    assessments, similarities and observations. Returns the node writes
    (one per organism, environment, assessment, similarity and
    observation)."""
    writes = 0
    for name, org in store.organisms.items():
        tx.run("MERGE (o:Organism {name: $n}) SET o.category = $c",
               n=name, c=org["category"])
        writes += 1
        for color in org["colors"]:
            tx.run("MERGE (c:Color {name: $c}) WITH c "
                   "MATCH (o:Organism {name: $n}) MERGE (o)-[:HAS_COLOR]->(c)",
                   c=color, n=name)
        for tex in org["textures"]:
            tx.run("MERGE (t:Texture {name: $t}) WITH t "
                   "MATCH (o:Organism {name: $n}) MERGE (o)-[:HAS_TEXTURE]->(t)",
                   t=tex, n=name)
        for pat in org["patterns"]:
            tx.run("MERGE (p:Pattern {type: $p}) WITH p "
                   "MATCH (o:Organism {name: $n}) MERGE (o)-[:HAS_PATTERN]->(p)",
                   p=pat, n=name)
    for (etype, desc, src), env in store.environments.items():
        tx.run("MERGE (e:Environment {type: $t, description: $d, source_file: $s}) "
               "SET e.lighting_condition = $l",
               t=etype, d=desc, s=src, l=env["lighting"])
        writes += 1
    for aid, ca in store.assessments.items():
        etype, desc, src = ca["env_key"]
        tx.run("MERGE (ca:CamouflageAssessment {id: $id}) "
               "SET ca.camouflage_score=$sc, ca.confidence=$cf, "
               "    ca.is_camouflaged=$ic, ca.camouflage_type=$ct "
               "WITH ca MATCH (e:Environment {type:$t, description:$d, source_file:$s}) "
               "MERGE (e)-[:HAS_CAMOUFLAGE_ASSESSMENT]->(ca)",
               id=aid, sc=ca["camouflage_score"], cf=ca["confidence"],
               ic=ca["is_camouflaged"], ct=ca["camouflage_type"],
               t=etype, d=desc, s=src)
        writes += 1
    for sid, sm in store.similarities.items():
        tx.run("MERGE (sm:SimilarityMetric {id: $id}) "
               "SET sm.color_similarity=$cs, sm.texture_similarity=$ts, "
               "    sm.contrast_difference=$cd "
               "WITH sm MATCH (ca:CamouflageAssessment {id: $aid}) "
               "MERGE (ca)-[:HAS_SIMILARITY]->(sm)",
               id=sid, cs=sm["color_similarity"], ts=sm["texture_similarity"],
               cd=sm["contrast_difference"], aid=sm["assessment_id"])
        writes += 1
    for oid, obs in store.observations.items():
        etype, desc, src = obs["env_key"]
        tx.run("MERGE (oc:ObservationContext {id: $id}) SET oc.source_file=$s "
               "WITH oc MATCH (o:Organism {name: $n}) "
               "MATCH (e:Environment {type:$t, description:$d, source_file:$s}) "
               "MERGE (oc)-[:HAS_ORGANISM]->(o) MERGE (oc)-[:OBSERVED_IN]->(e)",
               id=oid, s=src, n=obs["organism"], t=etype, d=desc)
        writes += 1
    return writes


def export_to_neo4j(store: CamouflageKnowledgeStore, uri: str, user: str,
                    password: str, database: str = "neo4j",
                    batch_size: int = 50) -> int:
    """Write the whole store into a Neo4j database in one write
    transaction, after the reference's eight uniqueness constraints (each
    one's failure, such as an older server's syntax, is ignored). Returns
    the node-write count (of the attempt that committed, where the JAX
    package adds up every attempt the driver retries). Idempotent: every
    write is a MERGE keyed as those constraints are. ``batch_size`` is
    accepted for the JAX package's signature and unused there as here."""
    if not neo4j_available():
        raise RuntimeError("neo4j driver not installed; the in-process store "
                           "(CamouflageKnowledgeStore) is the supported backend")
    from neo4j import GraphDatabase

    driver = GraphDatabase.driver(uri, auth=(user, password))
    writes = 0
    try:
        with driver.session(database=database) as session:
            for c in _CONSTRAINTS:
                try:
                    session.run(c)
                except Exception:
                    pass

            def tx_fn(tx):
                nonlocal writes
                writes = _write_store(tx, store)

            session.execute_write(tx_fn)
    finally:
        driver.close()
    return writes
