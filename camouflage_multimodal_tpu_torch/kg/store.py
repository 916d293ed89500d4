"""In-process columnar knowledge-graph store: the port's own copy of
``camouflage_multimodal_tpu/kg/store.py``.

It replaces the reference's external Neo4j dependency
(SURVEY.md §7, key decision 5): the reference's Cypher workload is a small
set of fixed-shape joins — a MERGE-based ingest
(``ingest_to_neo4j.py:240-403``), a category census and a per-category
subgraph extraction (``train_model.py:114-152``) — so the property graph
lives in plain Python dicts/sets with the same MERGE semantics
(idempotent upserts keyed exactly like the Neo4j uniqueness constraints at
``ingest_to_neo4j.py:200-238``), making the whole KG pipeline deterministic,
serverless and testable.

The ingest is resumable through the same append-only ``processed_files.txt``
log protocol as the reference (``ingest_to_neo4j.py:409-417``). ``save`` and
``load`` use the JSON format ``cmtpu-kg-store-v1``, so either package reads
the other's store. The JAX package's ``load`` also unpickles stores saved
before that format existed; nothing in the repository is such a file, and
this copy refuses them.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from camouflage_multimodal_tpu_torch.kg.normalize import extract_structured

logger = logging.getLogger(__name__)


class CamouflageKnowledgeStore:
    """Property graph with Organism / Color / Texture / Pattern / Environment /
    CamouflageAssessment / SimilarityMetric / LightingCondition /
    ObservationContext node types (graph structure of ingest_to_neo4j.py:6-13).
    """

    def __init__(self) -> None:
        # organism name → {"category", "colors": set, "textures": set, "patterns": set}
        self.organisms: Dict[str, Dict[str, Any]] = {}
        # env key (type, desc[:200], source_file) → {"lighting", "colors": set, "textures": set}
        self.environments: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        # assessment id → properties + env key
        self.assessments: Dict[str, Dict[str, Any]] = {}
        # similarity id → properties + assessment id
        self.similarities: Dict[str, Dict[str, Any]] = {}
        # observation id → {"organism", "env_key", "source_file"}
        self.observations: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    # Ingest (MERGE semantics of _create_batch_graph_v2)
    # ------------------------------------------------------------------

    def ingest_record(self, data: Dict[str, Any]) -> None:
        name = data["organism_name"]
        org = self.organisms.setdefault(
            name, {"category": None, "colors": [], "textures": [], "patterns": []}
        )
        org["category"] = data["category"]  # SET semantics: last writer wins
        for c in data["organism_colors"]:
            if c not in org["colors"]:
                org["colors"].append(c)
        for t in data["organism_textures"]:
            if t not in org["textures"]:
                org["textures"].append(t)
        if data["pattern"] not in org["patterns"]:
            org["patterns"].append(data["pattern"])

        env_key = (data["environment_type"], data["environment_description"][:200],
                   data["source_file"])
        env = self.environments.setdefault(
            env_key, {"lighting": None, "colors": [], "textures": []}
        )
        env["lighting"] = data["lighting_condition"]
        for c in data["background_colors"]:
            if c not in env["colors"]:
                env["colors"].append(c)
        for t in data["background_textures"]:
            if t not in env["textures"]:
                env["textures"].append(t)

        assessment_id = f"assess_{data['source_file']}"
        self.assessments[assessment_id] = {
            "camouflage_score": data["camouflage_score"],
            "confidence": data["confidence"],
            "is_camouflaged": data["is_camouflaged"],
            "camouflage_type": data["camouflage_type"],
            "env_key": env_key,
        }

        metric_id = f"sim_{data['source_file']}"
        self.similarities[metric_id] = {
            "color_similarity": data["color_similarity"],
            "texture_similarity": data["texture_similarity"],
            "contrast_difference": data["contrast_difference"],
            "assessment_id": assessment_id,
        }

        observation_id = f"obs_{name}_{data['source_file']}"
        self.observations[observation_id] = {
            "organism": name,
            "env_key": env_key,
            "source_file": data["source_file"],
        }

    def ingest_annotation(self, json_obj: Dict[str, Any], source_file: str) -> None:
        self.ingest_record(extract_structured(json_obj, source_file))

    def ingest_directory(self, annotation_dir: str, processed_log: Optional[str] = None,
                         max_files: Optional[int] = None) -> Tuple[int, int]:
        """Ingest every ``*.json`` annotation; resumable via the append-only
        processed-files log (same protocol as ingest_to_neo4j.py:409-417,431-434).
        Returns (success_count, failed_count)."""
        processed: Set[str] = set()
        if processed_log and os.path.exists(processed_log):
            with open(processed_log) as f:
                processed = set(f.read().splitlines())

        files = sorted(f for f in os.listdir(annotation_dir) if f.endswith(".json"))
        files = [f for f in files if f not in processed]
        if max_files:
            files = files[:max_files]

        success = failed = 0
        log_f = open(processed_log, "a") if processed_log else None
        try:
            for filename in files:
                try:
                    with open(os.path.join(annotation_dir, filename), encoding="utf-8") as f:
                        obj = json.load(f)
                    self.ingest_annotation(obj, filename)
                    success += 1
                    if log_f:
                        log_f.write(filename + "\n")
                except Exception as e:  # per-item fault tolerance, like the reference
                    logger.error("Error: %s: %s", filename, e)
                    failed += 1
        finally:
            if log_f:
                log_f.close()
        return success, failed

    # ------------------------------------------------------------------
    # Queries (Cypher workload of train_model.py / extract_kg_embeddings.py)
    # ------------------------------------------------------------------

    def categories(self) -> List[Tuple[str, int]]:
        """Distinct organism categories with counts, ordered count DESC
        (train_model.py:353-358); name ASC tiebreak for determinism."""
        counts: Dict[str, int] = {}
        for org in self.organisms.values():
            if org["category"] is not None:
                counts[org["category"]] = counts.get(org["category"], 0) + 1
        return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def extract_category_subgraphs(self, category: str, limit: int = 50) -> List[Dict[str, Any]]:
        """All (organism, observation, environment, assessment, similarity)
        records for a category (the Cypher path at train_model.py:122-141),
        each with the organism's accumulated color/texture/pattern satellites
        and the environment's colors/textures/lighting. Ordered by
        (organism, source_file) for determinism; LIMIT applied after."""
        records = []
        for obs_id in sorted(self.observations):
            obs = self.observations[obs_id]
            org = self.organisms.get(obs["organism"])
            if org is None or org["category"] != category:
                continue
            env = self.environments[obs["env_key"]]
            assessment_id = f"assess_{obs['source_file']}"
            ca = self.assessments.get(assessment_id)
            sm = self.similarities.get(f"sim_{obs['source_file']}")
            if ca is None or sm is None:
                continue
            records.append({
                "organism_name": obs["organism"],
                "category": category,
                "env_type": obs["env_key"][0],
                "assessment": ca,
                "similarity": sm,
                "org_colors": list(org["colors"]),
                "org_textures": list(org["textures"]),
                "org_patterns": list(org["patterns"]),
                "env_colors": list(env["colors"]),
                "env_textures": list(env["textures"]),
                "lighting": env["lighting"],
                "source_file": obs["source_file"],
            })
            if len(records) >= limit:
                break
        return records

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Durable versioned JSON (no pickle: the file carries no Python
        module paths, so refactors can't orphan it).
        Tuple env keys are encoded as lists; everything else is already
        JSON-native (str/list/None record fields)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = {
            "format": "cmtpu-kg-store-v1",
            "organisms": self.organisms,
            "environments": [[list(k), v]
                             for k, v in self.environments.items()],
            "assessments": self.assessments,
            "similarities": self.similarities,
            "observations": self.observations,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CamouflageKnowledgeStore":
        store = cls()
        with open(path, "rb") as f:
            magic = f.read(1)
        if magic != b"{":
            raise ValueError(f"{path}: not a JSON KG store (a pickled store of "
                             "the JAX package's early format is not read here)")
        with open(path) as f:
            state = json.load(f)
        if state.get("format") != "cmtpu-kg-store-v1":
            raise ValueError(f"unknown KG store format in {path}")
        state["environments"] = {tuple(k): v for k, v in state["environments"]}
        for table in ("assessments", "observations"):
            for rec in state[table].values():
                if isinstance(rec.get("env_key"), list):
                    rec["env_key"] = tuple(rec["env_key"])
        store.organisms = state["organisms"]
        store.environments = state["environments"]
        store.assessments = state["assessments"]
        store.similarities = state["similarities"]
        store.observations = state["observations"]
        return store
