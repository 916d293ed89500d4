"""Subgraph → padded array featurization for the KG GNN: the port's own
copy of ``camouflage_multimodal_tpu/kg/featurize.py`` (the reference's
``Neo4jGraphExtractorV2._build_subgraph_from_record`` / ``_encode_nodes`` /
``_encode_edges``, ``train_model.py:154-342``), numpy in and out:

Node order: Organism(0) → ObservationContext(1) → Environment(2) →
CamouflageAssessment(3) → SimilarityMetric(4) → organism colors → organism
textures → organism patterns → environment colors → environment textures →
lighting. Edges exactly as listed there, bidirectional.

32-dim node features: one-hot node type [0-8], numeric
score/confidence/similarity [9-11], 12-color vocab substring one-hot
[12-23], 8-texture vocab [24-31].

Fixed-size buckets (N_max nodes) with a validity mask and a dense boolean
adjacency stand in for PyG edge_index lists.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

NODE_TYPES = [
    "Organism", "Color", "Texture", "Pattern", "Environment",
    "CamouflageAssessment", "SimilarityMetric", "LightingCondition",
    "ObservationContext",
]

COLOR_VOCAB = [
    "green", "brown", "gray", "grey", "yellow", "orange",
    "blue", "white", "black", "red", "beige", "sandy",
]

TEXTURE_VOCAB = [
    "smooth", "rough", "scaly", "scaled", "bumpy", "fuzzy",
    "slimy", "hard", "soft", "pebbled",
]

FEATURE_DIM = 32


def _encode_node(node: Dict[str, Any]) -> np.ndarray:
    feat = np.zeros(FEATURE_DIM, dtype=np.float32)
    ntype = node["type"]
    if ntype in NODE_TYPES:
        feat[NODE_TYPES.index(ntype)] = 1.0
    if ntype == "CamouflageAssessment":
        feat[9] = node.get("camouflage_score", 0.5)
        feat[10] = node.get("confidence", 0.5)
        feat[11] = 1.0 if node.get("is_camouflaged", False) else 0.0
    elif ntype == "SimilarityMetric":
        feat[9] = node.get("color_sim", 0.5)
        feat[10] = node.get("texture_sim", 0.5)
        feat[11] = node.get("contrast", 0.5)
    if ntype == "Color":
        name = node.get("name", "").lower()
        for i, vocab_color in enumerate(COLOR_VOCAB):
            if vocab_color in name:
                feat[12 + i] = 1.0
    if ntype == "Texture":
        name = node.get("name", "").lower()
        for i, vocab_texture in enumerate(TEXTURE_VOCAB[:8]):
            if vocab_texture in name:
                feat[24 + i] = 1.0
    return feat


def build_subgraph(record: Dict[str, Any]) -> Dict[str, Any]:
    """Store record → {x: (N, 32), edges: [(src, dst)], y: float}."""
    nodes: List[Dict[str, Any]] = []
    edges: List[Tuple[int, int]] = []

    org_id = len(nodes)
    nodes.append({"type": "Organism"})
    oc_id = len(nodes)
    nodes.append({"type": "ObservationContext"})
    edges.append((oc_id, org_id))  # HAS_ORGANISM
    env_id = len(nodes)
    nodes.append({"type": "Environment"})
    edges.append((oc_id, env_id))  # OBSERVED_IN

    ca = record["assessment"]
    ca_id = len(nodes)
    nodes.append({
        "type": "CamouflageAssessment",
        "camouflage_score": float(ca["camouflage_score"]),
        "confidence": float(ca["confidence"]),
        "is_camouflaged": bool(ca["is_camouflaged"]),
    })
    edges.append((env_id, ca_id))  # HAS_CAMOUFLAGE_ASSESSMENT

    sm = record["similarity"]
    sm_id = len(nodes)
    nodes.append({
        "type": "SimilarityMetric",
        "color_sim": float(sm["color_similarity"]),
        "texture_sim": float(sm["texture_similarity"]),
        "contrast": float(sm["contrast_difference"]),
    })
    edges.append((ca_id, sm_id))  # HAS_SIMILARITY

    for color in record["org_colors"]:
        cid = len(nodes)
        nodes.append({"type": "Color", "name": color})
        edges.append((org_id, cid))
    for texture in record["org_textures"]:
        tid = len(nodes)
        nodes.append({"type": "Texture", "name": texture})
        edges.append((org_id, tid))
    for pattern in record["org_patterns"]:
        pid = len(nodes)
        nodes.append({"type": "Pattern", "name": pattern})
        edges.append((org_id, pid))
    for color in record["env_colors"]:
        cid = len(nodes)
        nodes.append({"type": "Color", "name": color})
        edges.append((env_id, cid))
    for texture in record["env_textures"]:
        tid = len(nodes)
        nodes.append({"type": "Texture", "name": texture})
        edges.append((env_id, tid))
    if record.get("lighting"):
        lid = len(nodes)
        nodes.append({"type": "LightingCondition", "condition": record["lighting"]})
        edges.append((env_id, lid))

    x = np.stack([_encode_node(n) for n in nodes])
    return {"x": x, "edges": edges, "y": float(ca["camouflage_score"])}


def pad_subgraphs(subgraphs: Sequence[Dict[str, Any]], max_nodes: int):
    """List of subgraphs → padded batch arrays.

    Returns (x (B, N, 32) f32, adjacency (B, N, N) bool, node_mask (B, N) bool,
    y (B,) f32). Graphs larger than ``max_nodes`` are truncated (satellite
    nodes dropped last) with a count reported via the 5th return value."""
    B = len(subgraphs)
    x = np.zeros((B, max_nodes, FEATURE_DIM), dtype=np.float32)
    adj = np.zeros((B, max_nodes, max_nodes), dtype=bool)
    mask = np.zeros((B, max_nodes), dtype=bool)
    y = np.zeros((B,), dtype=np.float32)
    truncated = 0
    for b, sg in enumerate(subgraphs):
        n = sg["x"].shape[0]
        if n > max_nodes:
            truncated += 1
            n = max_nodes
        x[b, :n] = sg["x"][:n]
        mask[b, :n] = True
        y[b] = sg["y"]
        for src, dst in sg["edges"]:
            if src < n and dst < n:
                adj[b, src, dst] = True
                adj[b, dst, src] = True
    return x, adj, mask, y, truncated
