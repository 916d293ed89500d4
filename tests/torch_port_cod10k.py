"""Seeded trees in COD10K's layout and a stand-in for the reference's
``fusion_model.py``, shared by the tests of the quality and fidelity
scripts (``tests/test_torch_port_fidelity.py``,
``tests/test_torch_port_quality.py``).

A tree holds ``images/*.jpg`` with ``gt_object/``, ``gt_instance/`` and
``gt_edge/`` PNGs: CAM scenes (a textured disc in a smooth background, the
disc as object and instance GT, its ring as edge GT) named over the
committed KG categories and the four COD10K environments, and NonCAM
scenes with empty GT. NonCAM names sort after the CAM ones.
"""

import os
import pathlib

import numpy as np
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
KG_EMBEDDINGS = REPO / "artifacts" / "kg_embeddings" / "all_embeddings.npz"
ENVIRONMENTS = ("Aquatic", "Terrestrial", "Flying", "Amphibian")
GT_DIRS = ("gt_object", "gt_instance", "gt_edge")


def categories():
    with np.load(KG_EMBEDDINGS) as z:
        return sorted(z.files)


def scene(rng, size):
    """(uint8 image, uint8 disc mask, uint8 ring mask) of one CAM scene."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = rng.uniform(40, 200, 3)
    tilt = rng.uniform(-60, 60, (2, 3))
    img = base + yy[..., None] * tilt[0] + xx[..., None] * tilt[1]
    cy, cx = rng.uniform(0.3, 0.7, 2)
    r = rng.uniform(0.15, 0.28)
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    disc = d2 < r * r
    ring = (d2 >= (r - 0.03) ** 2) & (d2 < (r + 0.03) ** 2)
    stripes = (np.sin(xx * size / rng.uniform(2, 5)) > 0)[..., None] * 30
    obj = rng.uniform(40, 216, 3) + stripes
    img = np.where(disc[..., None], obj, img) + rng.normal(0, 4, img.shape)
    return (np.clip(img, 0, 255).astype(np.uint8), (disc * 255).astype(np.uint8),
            (ring * 255).astype(np.uint8))


def write_tree(root, n_cam: int, n_noncam: int = 1, size: int = 64, seed: int = 5):
    """Write a seeded tree under ``root``; returns the sorted image bases."""
    rng = np.random.default_rng(seed)
    cats = categories()
    for d in ("images",) + GT_DIRS:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    bases = []
    for i in range(n_cam + n_noncam):
        img, disc, ring = scene(rng, size)
        env = ENVIRONMENTS[i % 4]
        if i < n_cam:
            base = f"COD10K-CAM-{1 + i % 4}-{env}-{1 + i // 4}-{cats[i % len(cats)]}-{100 + i}"
            gts = (disc, disc, ring)
        else:
            base = f"COD10K-NonCAM-{1 + i % 4}-{env}-{1 + i // 4}-Background-{900 + i}"
            gts = (np.zeros_like(disc),) * 3
        Image.fromarray(img).save(os.path.join(root, "images", base + ".jpg"), quality=95)
        for d, gt in zip(GT_DIRS, gts):
            Image.fromarray(gt).save(os.path.join(root, d, base + ".png"))
        bases.append(base)
    return sorted(bases)


def rg_store(rng, names):
    """A seeded RG embedding store (20–39 nodes an image) of ``names``."""
    return {n: {"node_embeddings": rng.standard_normal((int(rng.integers(20, 40)), 128))
                .astype(np.float32),
                "graph_embedding": rng.standard_normal((1, 128)).astype(np.float32)}
            for n in names}


def link_kg_embeddings(root):
    """``root/artifacts/kg_embeddings/all_embeddings.npz`` → the committed
    file: where the JAX scripts read it relative to their working
    directory."""
    dst = pathlib.Path(root) / "artifacts" / "kg_embeddings" / "all_embeddings.npz"
    dst.parent.mkdir(parents=True, exist_ok=True)
    if not dst.exists():
        dst.symlink_to(KG_EMBEDDINGS)


def snapshot(root):
    """(path, size, mtime_ns) of every file under ``root``."""
    out = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            st = os.stat(os.path.join(dirpath, name))
            out.append((os.path.join(dirpath, name), st.st_size, st.st_mtime_ns))
    return sorted(out)


# The reference's ``fusion_model.py`` interface and state-dict layout
# (cross-attention fusion, four heads), written as plain torch for tests
# where the reference checkout is absent.
STAND_IN_FUSION_MODEL = '''
import torch
import torch.nn as nn


def _mlp(i, h, o, dropout, *tail):
    return nn.Sequential(nn.Linear(i, h), nn.ReLU(), nn.Dropout(dropout), nn.Linear(h, o),
                         *tail)


def _tokens(t):
    """2-D inputs get a token axis; 4-D ones (a KG stack of (1, dim) rows)
    are merged to 3-D, as the reference's forward does."""
    if t.dim() == 2:
        return t.unsqueeze(1)
    if t.dim() == 4:
        b, a, c, d = t.shape
        return t[:, 0] if a == 1 else t[:, :, 0] if c == 1 else t.reshape(b, a * c, d)
    return t


class CrossAttentionFusion(nn.Module):
    def __init__(self, rg_dim=128, kg_dim=128, hidden_dim=256, num_heads=8, dropout=0.3):
        super().__init__()
        self.rg_proj = nn.Linear(rg_dim, hidden_dim) if rg_dim != hidden_dim else nn.Identity()
        self.kg_proj = nn.Linear(kg_dim, hidden_dim) if kg_dim != hidden_dim else nn.Identity()
        self.cross_attn_rg2kg = nn.MultiheadAttention(hidden_dim, num_heads, dropout=dropout,
                                                      batch_first=True)
        self.cross_attn_kg2rg = nn.MultiheadAttention(hidden_dim, num_heads, dropout=dropout,
                                                      batch_first=True)
        self.ln_rg = nn.LayerNorm(hidden_dim)
        self.ln_kg = nn.LayerNorm(hidden_dim)
        self.ffn_rg = _mlp(hidden_dim, hidden_dim * 2, hidden_dim, dropout)
        self.ffn_kg = _mlp(hidden_dim, hidden_dim * 2, hidden_dim, dropout)
        self.fusion_layer = _mlp(hidden_dim * 2, hidden_dim, hidden_dim, dropout)

    def forward(self, rg, kg):
        rg_p, kg_p = self.rg_proj(_tokens(rg)), self.kg_proj(_tokens(kg))
        rg_att, w_rg2kg = self.cross_attn_rg2kg(rg_p, kg_p, kg_p)
        rg_att = self.ln_rg(rg_p + rg_att)
        rg_att = rg_att + self.ffn_rg(rg_att)
        kg_att, w_kg2rg = self.cross_attn_kg2rg(kg_p, rg_p, rg_p)
        kg_att = self.ln_kg(kg_p + kg_att)
        kg_att = kg_att + self.ffn_kg(kg_att)
        fused = self.fusion_layer(torch.cat([rg_att.mean(1), kg_att.mean(1)], dim=-1))
        return fused, {"rg2kg": w_rg2kg, "kg2rg": w_kg2rg}


class MultimodalCamouflageDetector(nn.Module):
    def __init__(self, rg_dim=128, kg_dim=128, hidden_dim=256, num_heads=8,
                 fusion_type="cross_attention", num_classes=2, dropout=0.3):
        super().__init__()
        self.fusion = CrossAttentionFusion(rg_dim, kg_dim, hidden_dim, num_heads, dropout)
        half = hidden_dim // 2
        self.mask_head = _mlp(hidden_dim, half, num_classes, dropout)
        self.instance_head = _mlp(hidden_dim, half, num_classes, dropout)
        self.edge_head = _mlp(hidden_dim, half, 1, dropout)
        self.score_head = _mlp(hidden_dim, half, 1, dropout, nn.Sigmoid())

    def forward(self, rg, kg, return_attention=False):
        fused, attn = self.fusion(rg, kg)
        out = (self.mask_head(fused), self.instance_head(fused), self.edge_head(fused),
               self.score_head(fused))
        return out + (attn,) if return_attention else out


def build_multimodal_model(config):
    return MultimodalCamouflageDetector(
        config.get("rg_dim", 128), config.get("kg_dim", 128), config.get("hidden_dim", 256),
        config.get("num_heads", 8), config.get("fusion_type", "cross_attention"),
        config.get("num_classes", 2), config.get("dropout", 0.3))
'''


def stand_in_fusion_module(monkeypatch, tmp_path):
    """Write the stand-in and point ``reference_impl.load_reference_fusion_module``
    (the one loader both packages' scripts call) at it."""
    import sys

    if str(REPO / "tools") not in sys.path:
        monkeypatch.syspath_prepend(str(REPO / "tools"))
    import reference_impl

    path = tmp_path / "fusion_model.py"
    path.write_text(STAND_IN_FUSION_MODEL)
    monkeypatch.setattr(reference_impl.load_reference_fusion_module, "__defaults__",
                        (str(path),))
    return str(path)
