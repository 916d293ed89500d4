"""Annotation-vocabulary normalization: the port's own copy of
``camouflage_multimodal_tpu/kg/normalize.py`` (the reference ingester's
normalization tables and text-mining helpers, ``ingest_to_neo4j.py:43-177``).
These tables are data constants of the pipeline — they must match exactly for
the knowledge graph to have the same node vocabulary.
"""

from __future__ import annotations

from typing import Any, Dict, List

COLOR_MAPPING = {
    "olive green": "yellow-green", "olive-green": "yellow-green",
    "light yellowish-beige": "beige", "yellowish-beige": "beige",
    "pale blue-grey": "blue-gray", "blue-grey": "blue-gray",
    "light orange": "orange", "light pinkish-white": "pink-white",
    "sandy brown": "sandy-brown", "dark green": "green-dark",
    "light green": "green-light", "dark water": "water-dark",
    "murky blue": "blue-murky", "deep blue": "blue-deep",
    "brownish-green": "brown-green", "translucent": "transparent",
}

TEXTURE_MAPPING = {
    "gravel": "pebbled", "rocky": "rough", "smooth": "smooth",
    "scaly": "scaled", "tentacled": "tentacle-textured",
    "root-like": "fibrous", "vegetation": "leafy", "coral": "coral-textured",
}

PATTERN_MAPPING = {
    "disruptive pattern": "disruptive", "shape disruption": "disruptive",
    "spotted": "spotted", "striped": "striped", "uniform": "uniform",
    "mottled": "mottled", "banded": "banded",
}

ENVIRONMENT_KEYWORDS = {
    "underwater": "aquatic", "ocean": "marine", "water": "aquatic",
    "forest": "terrestrial-forest", "desert": "terrestrial-desert",
    "grassland": "terrestrial-grassland", "reef": "marine-reef",
    "coral": "marine-coral", "seabed": "marine-seabed",
    "sandy": "marine-sandy", "rocky": "marine-rocky",
}

SIMILARITY_MAPPING = {
    "high": 0.8, "medium": 0.5, "low": 0.2,
    "very high": 0.9, "very low": 0.1,
}

_EXTRA_COLORS = [
    "orange", "pink", "white", "black", "brown", "green",
    "blue", "yellow", "red", "gray", "grey", "beige", "purple",
]


def normalize_color(color_text: str) -> str:
    return COLOR_MAPPING.get(color_text.lower().strip(), color_text.lower().strip())


def normalize_texture(texture_text: str) -> str:
    return TEXTURE_MAPPING.get(texture_text.lower().strip(), texture_text.lower().strip())


def normalize_pattern(pattern_text: str) -> str:
    return PATTERN_MAPPING.get(pattern_text.lower().strip(), pattern_text.lower().strip())


def extract_colors_from_text(text: str) -> List[str]:
    """Keyword-scan free text for known colors (ingest_to_neo4j.py:91-100).

    Returned sorted for determinism (the reference iterated a Python set,
    which is hash-order; sorting changes nothing downstream because colors
    become an unordered node set)."""
    colors = set()
    text_lower = text.lower()
    all_colors = set(COLOR_MAPPING.keys()) | set(COLOR_MAPPING.values()) | set(_EXTRA_COLORS)
    for color in all_colors:
        if color in text_lower:
            colors.add(normalize_color(color))
    return sorted(colors) if colors else ["unknown"]


def extract_textures_from_text(text: str) -> List[str]:
    textures = set()
    text_lower = text.lower()
    all_textures = set(TEXTURE_MAPPING.keys()) | set(TEXTURE_MAPPING.values())
    for texture in all_textures:
        if texture in text_lower:
            textures.add(normalize_texture(texture))
    return sorted(textures) if textures else ["smooth"]


def determine_environment_type(background_desc: str) -> str:
    desc_lower = background_desc.lower()
    for keyword, env_type in ENVIRONMENT_KEYWORDS.items():
        if keyword in desc_lower:
            return env_type
    return "unknown"


def text_similarity_to_numeric(text: str) -> float:
    return SIMILARITY_MAPPING.get(text.lower().strip(), 0.5)


def extract_structured(json_obj: Dict[str, Any], source_file: str) -> Dict[str, Any]:
    """Annotation JSON → structured record (ingest_to_neo4j.py:122-177)."""
    organism_name = json_obj.get("object_name", "Unknown")
    category = json_obj.get("object_category", "Unknown")
    background_desc = json_obj.get("background_description", "")
    explanation = json_obj.get("explanation", "")

    pattern_raw = json_obj.get("camouflage_type", "None")
    pattern = normalize_pattern(pattern_raw) if pattern_raw.lower() != "none" else "uniform"

    camo_presence = json_obj.get("camouflage_presence", "Unknown")

    lighting_condition = "bright"
    if "dark" in background_desc.lower() or "dim" in background_desc.lower():
        lighting_condition = "dim"
    elif "shadow" in background_desc.lower():
        lighting_condition = "shadowed"

    return {
        "organism_name": organism_name,
        "category": category,
        "environment_type": determine_environment_type(background_desc),
        "environment_description": background_desc,
        "organism_colors": extract_colors_from_text(explanation),
        "background_colors": extract_colors_from_text(background_desc),
        "pattern": pattern,
        "organism_textures": extract_textures_from_text(explanation),
        "background_textures": extract_textures_from_text(background_desc),
        "lighting_condition": lighting_condition,
        "color_similarity": text_similarity_to_numeric(json_obj.get("color_similarity", "medium")),
        "texture_similarity": text_similarity_to_numeric(json_obj.get("texture_similarity", "medium")),
        "contrast_difference": text_similarity_to_numeric(json_obj.get("contrast_difference", "medium")),
        "camouflage_score": float(json_obj.get("camouflage_score", 0.0)),
        "confidence": float(json_obj.get("confidence", 0.0)),
        "is_camouflaged": camo_presence.lower() == "camouflage",
        "camouflage_type": pattern,
        "source_file": source_file,
        "explanation": explanation,
    }
