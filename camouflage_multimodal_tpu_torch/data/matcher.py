"""RG ↔ KG embedding matcher: extracted stores → the fusion dataset's records.

Port of ``camouflage_multimodal_tpu/data/matcher.py``:

* category ↔ id maps in the KG store's insertion order;
* the organism from COD10K name token 5, matched exactly first, then as a
  substring either way (case-insensitive);
* two modes: ``use_all_categories=True`` stacks every category vector (the
  cross-attention fusion's input), else the matched category alone, with
  the mean of all categories where nothing matches;
* ``create_matched_dataset`` / ``save_matched_dataset`` with the same
  record schema, in the RG store's order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from camouflage_multimodal_tpu_torch.core.artifacts import (
    load_kg_embeddings, load_rg_embeddings)


class EmbeddingMatcher:
    def __init__(self, rg_embeddings_path: str, kg_embeddings_path: str,
                 category_mapping: Optional[Dict[str, str]] = None) -> None:
        self.rg_embeddings = load_rg_embeddings(rg_embeddings_path)
        self.kg_embeddings = load_kg_embeddings(kg_embeddings_path)
        self.category_mapping = category_mapping
        self.category_to_id = {cat: idx for idx, cat in enumerate(self.kg_embeddings)}
        self.id_to_category = {idx: cat for cat, idx in self.category_to_id.items()}

    def extract_category_from_filename(self, filename: str) -> Optional[str]:
        """COD10K name token 5 → KG category (exact, then substring both ways)."""
        parts = os.path.splitext(filename)[0].split("-")
        if len(parts) < 6:
            return None
        organism = parts[5]
        if organism in self.kg_embeddings:
            return organism
        for category in self.kg_embeddings:
            if organism.lower() in category.lower() or category.lower() in organism.lower():
                return category
        return None

    def get_kg_embedding_for_image(self, image_name: str,
                                   use_all_categories: bool = False
                                   ) -> Tuple[np.ndarray, List[int]]:
        every = np.concatenate(list(self.kg_embeddings.values()), axis=0)
        if use_all_categories:
            return every, list(range(len(self.kg_embeddings)))
        if self.category_mapping and image_name in self.category_mapping:
            category = self.category_mapping[image_name]
        else:
            category = self.extract_category_from_filename(image_name)
        if category and category in self.kg_embeddings:
            return self.kg_embeddings[category].reshape(1, -1), [self.category_to_id[category]]
        return every.mean(axis=0, keepdims=True), [0]

    def create_matched_dataset(self, use_all_kg_categories: bool = True) -> List[Dict[str, Any]]:
        matched = []
        for image_name, rg in self.rg_embeddings.items():
            kg_emb, category_ids = self.get_kg_embedding_for_image(
                image_name, use_all_categories=use_all_kg_categories)
            matched.append({
                "image_name": image_name,
                "rg_node_embeddings": rg["node_embeddings"],
                "rg_graph_embedding": rg["graph_embedding"],
                "kg_embeddings": kg_emb,
                "category_ids": category_ids,
                "num_rg_nodes": rg["node_embeddings"].shape[0],
                "num_kg_categories": kg_emb.shape[0],
            })
        return matched

    def save_matched_dataset(self, output_path: str,
                             use_all_kg_categories: bool = True) -> List[Dict[str, Any]]:
        """The records as a pickled object array (``np.save``)."""
        matched = self.create_matched_dataset(use_all_kg_categories)
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        np.save(output_path, np.asarray(matched, dtype=object), allow_pickle=True)
        return matched


def build_ordered_kg_tensor(kg_embeddings: Dict[str, np.ndarray]
                            ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Categories stacked in sorted order → ((num_kg, dim) float32, ordered
    dict category → embedding), as ``test_multimodal.build_ordered_kg_tensor``."""
    keys = sorted(kg_embeddings)
    ordered = {k: np.asarray(kg_embeddings[k], np.float32).reshape(-1) for k in keys}
    return np.stack([ordered[k] for k in keys]), ordered
