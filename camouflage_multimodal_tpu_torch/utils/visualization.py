"""Host-side report figures (training curves, attention map, comparison
strip, metrics bars); port of
``camouflage_multimodal_tpu/utils/visualization.py``.

The rendered *figure spec* — panel counts, figsizes, colormaps, title
strings, the 0.8/0.6 score color bands — is the behavioral contract of the
reference's ``utils/visualization.py:11-126``. Host-only: numpy inputs,
matplotlib's Agg backend, no device work.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


@contextmanager
def _figure(output_path: str, **subplots_kw):
    """Yield (fig, axes); on exit, tight-layout + save at 150 dpi + close."""
    fig, axes = plt.subplots(**subplots_kw)
    try:
        yield fig, axes
        fig.tight_layout()
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        fig.savefig(output_path, dpi=150, bbox_inches="tight")
    finally:
        plt.close(fig)


def _line_panel(ax, x, series, *, xlabel, ylabel, title):
    """One curves panel: series is [(values, style, label), ...]."""
    for values, style, label in series:
        ax.plot(x, values, style, label=label, linewidth=2)
    ax.set_xlabel(xlabel, fontsize=12)
    if ylabel:
        ax.set_ylabel(ylabel, fontsize=12)
    ax.set_title(title, fontsize=14, fontweight="bold")
    ax.legend()
    ax.grid(alpha=0.3)


def plot_training_history(history, output_path):
    """Loss + metric curves; accepts the reference's acc-keyed histories and
    this repo's F1-keyed ones (figure spec: reference visualization.py:11-40)."""
    epochs = range(1, len(history["train_loss"]) + 1)
    metric_keys = next(
        (pair for pair in (("train_acc", "val_acc"),
                           ("train_f1_class_1", "val_f1_class_1"))
         if pair[0] in history),
        None,
    )
    with _figure(output_path, nrows=1, ncols=2, figsize=(15, 5)) as (_, axes):
        _line_panel(axes[0], epochs,
                    [(history["train_loss"], "b-", "Train Loss"),
                     (history["val_loss"], "r-", "Val Loss")],
                    xlabel="Epoch", ylabel="Loss",
                    title="Training and Validation Loss")
        if metric_keys is not None:
            tr, va = metric_keys
            _line_panel(axes[1], epochs,
                        [(history[tr], "b-", tr), (history[va], "r-", va)],
                        xlabel="Epoch", ylabel=None,
                        title="Training and Validation Metric")


def plot_attention_heatmap(attention_weights, categories, output_path):
    """RG→KG cross-attention matrix (figure spec: reference
    visualization.py:42-62 — 'hot' cmap, categories on x when ≤20)."""
    weights = np.asarray(attention_weights)
    with _figure(output_path, figsize=(12, 8)) as (fig, ax):
        image = ax.imshow(weights, cmap="hot", aspect="auto")
        ax.set_xlabel("KG Categories", fontsize=12)
        ax.set_ylabel("RG Nodes (Regions)", fontsize=12)
        ax.set_title("Cross-Attention: RG → KG", fontsize=14, fontweight="bold")
        if len(categories) <= 20:
            ax.set_xticks(range(len(categories)))
            ax.set_xticklabels(categories, rotation=45, ha="right", fontsize=8)
        fig.colorbar(image, ax=ax, label="Attention Weight")


def plot_comparison(image, pred_mask, gt_mask, output_path):
    """Image | GT | prediction | hot-overlay strip (figure spec: reference
    visualization.py:64-90)."""
    image = np.asarray(image)
    panels = [
        ("Original Image", lambda ax: ax.imshow(image)),
        ("Ground Truth", lambda ax: ax.imshow(np.asarray(gt_mask), cmap="gray")),
        ("Prediction", lambda ax: ax.imshow(np.asarray(pred_mask), cmap="gray")),
        ("Prediction Overlay",
         lambda ax: (ax.imshow(image),
                     ax.imshow(np.asarray(pred_mask), alpha=0.5, cmap="hot"))),
    ]
    with _figure(output_path, nrows=1, ncols=4, figsize=(20, 5)) as (_, axes):
        for ax, (title, draw) in zip(axes, panels):
            draw(ax)
            ax.set_title(title, fontweight="bold")
            ax.axis("off")


# Score → bar color bands of the reference's metrics chart
# (visualization.py:101-107): green above 0.8, orange above 0.6, else red.
_SCORE_BANDS = ((0.8, "green"), (0.6, "orange"), (float("-inf"), "red"))


def _band_color(value: float) -> str:
    return next(color for threshold, color in _SCORE_BANDS if value > threshold)


def plot_metrics_summary(metrics_dict, output_path):
    """Color-banded metrics bar chart (figure spec: reference
    visualization.py:92-126)."""
    names = list(metrics_dict.keys())
    values = [float(v) for v in metrics_dict.values()]
    with _figure(output_path, figsize=(10, 6)) as (_, ax):
        bars = ax.bar(names, values, color=[_band_color(v) for v in values],
                      edgecolor="black", linewidth=1.5)
        ax.set_ylabel("Score", fontsize=12)
        ax.set_title("Evaluation Metrics", fontsize=14, fontweight="bold")
        ax.set_ylim([0, 1])
        ax.grid(axis="y", alpha=0.3)
        for bar, value in zip(bars, values):
            ax.text(bar.get_x() + bar.get_width() / 2.0, bar.get_height(),
                    f"{value:.3f}", ha="center", va="bottom", fontweight="bold")
        ax.tick_params(axis="x", rotation=45)
        for label in ax.get_xticklabels():
            label.set_ha("right")
