"""Figure panels mirroring the reference's result visualizations; port of
``camouflage_multimodal_tpu/viz.py``. Host-only: numpy inputs, matplotlib's
Agg backend, no device work."""

from __future__ import annotations

import os
from typing import Dict, Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def detection_panel(image: np.ndarray, segments: np.ndarray, heatmap: np.ndarray,
                    classification: str, color: str, mean_score: float,
                    coverage: float, output_path: str, image_name: str = "") -> None:
    """6-panel RG detection figure (region_graph/test.py:304-349)."""
    fig, axes = plt.subplots(2, 3, figsize=(18, 12))

    axes[0, 0].imshow(image)
    axes[0, 0].set_title(f"Original Image\n{image_name}", fontsize=14, fontweight="bold")

    axes[0, 1].imshow(segments, cmap="nipy_spectral")
    axes[0, 1].set_title(f"Superpixel Regions\n({len(np.unique(segments))} regions)",
                         fontsize=14, fontweight="bold")

    im1 = axes[0, 2].imshow(heatmap, cmap="hot", vmin=0, vmax=1)
    axes[0, 2].set_title(f"Camouflage Heatmap\nMean: {mean_score:.3f}",
                         fontsize=14, fontweight="bold")
    plt.colorbar(im1, ax=axes[0, 2], fraction=0.046, label="Probability")

    axes[1, 0].imshow(image)
    axes[1, 0].imshow(heatmap, alpha=0.6, cmap="hot", vmin=0, vmax=1)
    axes[1, 0].set_title("Detection Overlay", fontsize=14, fontweight="bold")

    pred_binary = (heatmap > 0.5).astype(float)
    axes[1, 1].imshow(pred_binary, cmap="gray")
    axes[1, 1].set_title(f"Binary Mask (>0.5)\nCoverage: {coverage:.1f}%",
                         fontsize=14, fontweight="bold")

    axes[1, 2].imshow(image)
    axes[1, 2].contour(pred_binary, levels=[0.5], colors="red", linewidths=2)
    axes[1, 2].set_title(f"{classification}\nScore: {mean_score:.3f}",
                         fontsize=14, fontweight="bold", color=color)

    for ax in axes.ravel():
        ax.axis("off")
    plt.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close()


def multimodal_panel(image: np.ndarray, predictions: Dict, attention: Optional[Dict],
                     kg_categories: Dict, output_path: str, image_name: str = "") -> None:
    """8-panel multimodal figure (test_multimodal.py:156-308): original,
    superpixels, prediction text, top-10 attended KG categories, class
    probabilities, confidence meter, stats panel. Class mapping: 1 =
    CAMOUFLAGED."""
    fig = plt.figure(figsize=(20, 10))

    ax1 = plt.subplot(2, 4, 1)
    ax1.imshow(image)
    ax1.set_title(f"Original Image\n{image_name}", fontweight="bold")
    ax1.axis("off")

    ax2 = plt.subplot(2, 4, 2)
    ax2.imshow(predictions["segments"], cmap="nipy_spectral")
    ax2.set_title(f"Superpixels\n{len(np.unique(predictions['segments']))} regions",
                  fontweight="bold")
    ax2.axis("off")

    probs = predictions["mask_prob"]
    not_camo_prob, camo_prob = float(probs[0]), float(probs[1])
    score = float(predictions["score"])
    pred_label = int(predictions["mask_pred"])

    ax3 = plt.subplot(2, 4, 3)
    ax3.imshow(image)
    if pred_label == 1:
        result_text = f"CAMOUFLAGED\nConfidence: {camo_prob:.2%}\nScore: {score:.3f}"
        color = "red"
    else:
        result_text = f"NOT CAMOUFLAGED\nConfidence: {not_camo_prob:.2%}\nScore: {score:.3f}"
        color = "green"
    ax3.text(0.5, -0.1, result_text, transform=ax3.transAxes, ha="center",
             fontsize=12, fontweight="bold", color=color,
             bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.8))
    ax3.set_title("Prediction", fontweight="bold")
    ax3.axis("off")

    if attention is not None and "rg2kg" in attention:
        ax4 = plt.subplot(2, 4, 4)
        attn = np.asarray(attention["rg2kg"])  # (num_rg, num_kg) or already averaged
        if attn.ndim == 2:
            attn = attn.mean(axis=0)
        top_k = min(10, attn.shape[0])
        top_idx = np.argsort(attn)[-top_k:][::-1]
        cat_keys = list(kg_categories.keys())
        ax4.barh(range(top_k), attn[top_idx], color="skyblue")
        ax4.set_yticks(range(top_k))
        ax4.set_yticklabels([cat_keys[i] for i in top_idx], fontsize=8)
        ax4.set_xlabel("Attention Weight")
        ax4.set_title("Top Attended KG Categories", fontweight="bold")
        ax4.invert_yaxis()

    ax5 = plt.subplot(2, 4, 5)
    ax5.bar(["Not Camouflaged", "Camouflaged"], [not_camo_prob, camo_prob],
            color=["green", "red"], alpha=0.7)
    ax5.set_ylabel("Probability")
    ax5.set_ylim([0, 1])
    ax5.set_title("Class Probabilities", fontweight="bold")
    ax5.axhline(y=0.5, color="black", linestyle="--", alpha=0.5)

    ax6 = plt.subplot(2, 4, 6)
    confidence = max(camo_prob, not_camo_prob)
    c = "red" if confidence < 0.6 else "orange" if confidence < 0.8 else "green"
    ax6.barh([0], [confidence], color=[c], height=0.5)
    ax6.set_xlim([0, 1])
    ax6.set_yticks([])
    ax6.set_xlabel("Confidence")
    ax6.set_title(f"Model Confidence: {confidence:.1%}", fontweight="bold")

    ax7 = plt.subplot(2, 4, (7, 8))
    stats = (
        "STATISTICS\n\n"
        f"Prediction: {'Camouflaged' if pred_label == 1 else 'Not Camouflaged'}\n"
        f"Camo Prob: {camo_prob:.2%}\n"
        f"Not Camo Prob: {not_camo_prob:.2%}\n\n"
        f"Instance Pred: {predictions.get('instance_pred', 0)}\n"
        f"Score: {score:.3f}\n\n"
        f"Regions: {len(np.unique(predictions['segments']))}\n"
    )
    ax7.text(0.02, 0.5, stats, ha="left", va="center", fontsize=15,
             fontfamily="monospace",
             bbox=dict(boxstyle="round", facecolor="lightblue", alpha=0.8, pad=1))
    ax7.axis("off")

    plt.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close()
