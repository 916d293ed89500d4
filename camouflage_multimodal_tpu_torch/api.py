"""Public API: load the models, predict from images, score a directory.

Port of ``camouflage_multimodal_tpu/api.py``: ``load_rg_model``,
``load_multimodal_model``, ``MultimodalPredictor``, ``classification_bands``,
``detect_camouflage``, ``test_image_directory`` and ``evaluate_directory``,
plus ``load_kg_model`` for the knowledge-graph GNN (the JAX package reads
that checkpoint inline in its ``extract-kg`` command). Checkpoints are this
repo's ``.ckpt`` files or the reference's ``.pth`` / ``.pt``
(:mod:`core.torch_compat`). Everything runs on ``device`` — ``"cuda"`` by
default, which raises when no card is visible; ``"cpu"`` runs the plain
versions. Results come back as numpy arrays, as from the JAX API. The
figures (``save_figures=True``, ``visualize_prediction``) are drawn on the
host by :mod:`viz`, which loads matplotlib only when a figure is asked for.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch import native
from camouflage_multimodal_tpu_torch.convert import (
    fusion_state_dict, knowledge_graph_state_dict, region_graph_state_dict)
from camouflage_multimodal_tpu_torch.core import stages
from camouflage_multimodal_tpu_torch.core.checkpoint import load_checkpoint, scalar
from camouflage_multimodal_tpu_torch.core.device import resolve_device
from camouflage_multimodal_tpu_torch.core.torch_compat import load_torch_checkpoint
from camouflage_multimodal_tpu_torch.data import (
    build_ordered_kg_tensor, load_image_rgb, load_image_u8, load_kg_embeddings, load_mask)
from camouflage_multimodal_tpu_torch.eval.curves import batch_curve_metrics
from camouflage_multimodal_tpu_torch.eval.metrics import batch_evaluate, evaluate_segmentation
from camouflage_multimodal_tpu_torch.extract import pipeline_device
from camouflage_multimodal_tpu_torch.models.fusion import (
    MultimodalCamouflageDetector, build_multimodal_model)
from camouflage_multimodal_tpu_torch.models.knowledge_graph import KnowledgeGraphGNN
from camouflage_multimodal_tpu_torch.models.region_graph import RegionGraphGNN
from camouflage_multimodal_tpu_torch.parallel.distributed import process_count
from camouflage_multimodal_tpu_torch.parallel.sharding import (
    block, data_group, make_mesh, scatter_rows)
from camouflage_multimodal_tpu_torch.pipeline import MultimodalPipeline, RegionGraphPipeline

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def classification_bands(mean_score: float) -> Tuple[str, str]:
    """The reference's 4-level classification of a heatmap's mean score."""
    if mean_score > 0.35:
        return "HIGHLY CAMOUFLAGED", "red"
    if mean_score > 0.20:
        return "MODERATELY CAMOUFLAGED", "orange"
    if mean_score > 0.10:
        return "SLIGHTLY CAMOUFLAGED", "yellow"
    return "NOT CAMOUFLAGED", "green"


def _is_torch_checkpoint(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".pth", ".pt")


def _variables(path: str, kind: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(JAX-layout variables, the file's other entries) of a ``.ckpt`` or a
    reference ``.pth`` / ``.pt``."""
    if _is_torch_checkpoint(path):
        return load_torch_checkpoint(path, kind=kind)
    ckpt = load_checkpoint(path)
    variables = {"params": ckpt["params"]}
    if "batch_stats" in ckpt:
        variables["batch_stats"] = ckpt["batch_stats"]
    return variables, ckpt


def load_rg_model(checkpoint_path: str, device: str | torch.device = "cuda"
                  ) -> RegionGraphGNN:
    """``RegionGraphGNN`` with the weights of a ``.ckpt`` or of the
    reference's bare-state-dict ``.pth``, in eval mode on ``device``. A
    ``.pth`` carries no config: its widths are read off the weights."""
    dev = resolve_device(device)
    variables, meta = _variables(checkpoint_path, "region_graph")
    params = variables["params"]
    gat = np.shape(params["gat_kernel"])          # (in, heads, hidden)
    cfg = meta.get("model_config", {})
    model = RegionGraphGNN(
        in_channels=int(scalar(cfg.get("in_channels", gat[0]))),
        hidden_channels=int(scalar(cfg.get("hidden_channels", gat[2]))),
        num_classes=int(scalar(cfg.get("num_classes", np.shape(params["fc_mask_2"]["bias"])[0]))),
    )
    model.load_state_dict(region_graph_state_dict(params, variables["batch_stats"]))
    return model.to(dev).eval()


def load_kg_model(checkpoint_path: str, device: str | torch.device = "cuda"
                  ) -> KnowledgeGraphGNN:
    """``KnowledgeGraphGNN`` with the weights of a ``.ckpt`` (the layout
    ``KGTrainer`` writes in both packages) or of the reference's ``.pth``,
    in eval mode on ``device``."""
    dev = resolve_device(device)
    variables, meta = _variables(checkpoint_path, "knowledge_graph")
    model = KnowledgeGraphGNN(embedding_dim=int(scalar(meta.get("embedding_dim", 128))))
    model.load_state_dict(knowledge_graph_state_dict(variables["params"],
                                                     variables["batch_stats"]))
    return model.to(dev).eval()


def load_multimodal_model(checkpoint_path: str, device: str | torch.device = "cuda"
                          ) -> Tuple[MultimodalCamouflageDetector, Dict[str, Any]]:
    """(fusion model in eval mode on ``device``, training config) from a
    ``.ckpt`` or a reference ``.pth`` of either generation, the model built
    from the config inside. Whatever ``use_pallas`` the model was trained
    with, inference runs its attention through the fused kernel."""
    dev = resolve_device(device)
    variables, meta = _variables(checkpoint_path, "fusion")
    config = meta.get("config") or {}
    model = build_multimodal_model({**config.get("model", config), "use_pallas": True})
    model.load_state_dict(fusion_state_dict(variables["params"]))
    return model.to(dev).eval(), config


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x.cpu().numpy()


class MultimodalPredictor:
    """RG pipeline + fusion model + KG tensor bundled for repeated calls."""

    def __init__(self, fusion_checkpoint: str, rg_checkpoint: str,
                 kg_embeddings_path: str, n_segments: int = 500,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        rg_model = load_rg_model(rg_checkpoint, self.device)
        self.fusion_model, self.config = load_multimodal_model(fusion_checkpoint,
                                                               self.device)
        self.rg_pipeline = RegionGraphPipeline(rg_model, n_segments=n_segments)
        self.pipeline = MultimodalPipeline(self.rg_pipeline, self.fusion_model)
        kg, self.kg_ordered = build_ordered_kg_tensor(
            load_kg_embeddings(kg_embeddings_path))
        self.kg_tensor = torch.from_numpy(kg).to(self.device)

    def predict_batch(self, images: np.ndarray) -> Dict[str, Any]:
        """(B, H, W, 3) uint8 — or float in [0, 1] — images → numpy outputs;
        ``"attention"`` only where the fusion has attention maps."""
        if images.dtype != np.uint8:
            images = (np.asarray(images) * 255.0).round().astype(np.uint8)
        batch = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        return _to_numpy(self.pipeline(batch, self.kg_tensor))

    def predict_single_image(self, image_path: str):
        """(predictions, attention — None for late fusion — , kg_ordered)
        like the reference's ``test_multimodal.predict_single_image``."""
        image = load_image_rgb(image_path, self.rg_pipeline.image_size)
        out = self.predict_batch(image[None])
        node_mask = out["node_mask"][0]
        attn = None
        if "attention" in out:
            attn = {
                "rg2kg": out["attention"]["rg2kg"][0][node_mask],
                "kg2rg": out["attention"]["kg2rg"][0][:, node_mask],
            }
        predictions = {
            "mask_logits": out["mask_logits"][0],
            "mask_prob": out["mask_prob"][0],
            "mask_pred": int(np.argmax(out["mask_logits"][0])),
            "instance_prob": out["instance_prob"][0],
            "instance_pred": int(np.argmax(out["instance_logits"][0])),
            "edge_prob": float(out["edge_prob"][0, 0]),
            "score": float(out["score"][0, 0]),
            "segments": out["segments"][0],
            "heatmap": out["heatmap"][0],
        }
        return predictions, attn, self.kg_ordered


def detect_camouflage(image_path: str, checkpoint_path: str,
                      output_dir: str = "results",
                      mask_path: Optional[str] = None,
                      n_segments: int = 500,
                      pipeline: Optional[RegionGraphPipeline] = None,
                      save_figures: bool = True,
                      image_size: int = 256,
                      paint_mapping: str = "corrected",
                      device: str | torch.device = "cuda"):
    """One image through the RG pipeline → (heatmap, mean score,
    classification band, GT metrics or None). ``pipeline`` reuses a built
    one (then ``checkpoint_path`` is not read); ``paint_mapping="verbatim"``
    reproduces the reference's off-by-one heatmaps. ``save_figures`` writes
    the 6-panel ``detection_<name>`` figure and the ``mask_<name>`` heatmap
    into ``output_dir``."""
    if pipeline is None:
        pipeline = RegionGraphPipeline(load_rg_model(checkpoint_path, device),
                                       n_segments=n_segments, image_size=image_size,
                                       paint_mapping=paint_mapping)
    dev = pipeline_device(pipeline)
    image = load_image_rgb(image_path, pipeline.image_size)
    u8 = (image * 255.0).round().astype(np.uint8)
    out = pipeline(stages.upload(u8[None], dev))
    heatmap_dev = out["heatmap"][0]
    heatmap = heatmap_dev.cpu().numpy()
    mean_score = float(heatmap.mean())
    classification, color = classification_bands(mean_score)

    metrics = None
    if mask_path and os.path.exists(mask_path):
        gt = torch.from_numpy(load_mask(mask_path, pipeline.image_size)).to(dev)
        metrics = {k: float(v) for k, v in evaluate_segmentation(heatmap_dev, gt).items()}

    if save_figures:
        from PIL import Image

        from camouflage_multimodal_tpu_torch.viz import detection_panel

        os.makedirs(output_dir, exist_ok=True)
        base = os.path.basename(image_path)
        coverage = float((heatmap > 0.5).sum() / heatmap.size * 100)
        detection_panel(image, out["segments"][0].cpu().numpy(), heatmap, classification,
                        color, mean_score, coverage,
                        os.path.join(output_dir, f"detection_{base}"), base)
        Image.fromarray((heatmap * 255).astype(np.uint8)).save(
            os.path.join(output_dir, f"mask_{base}"))
    return heatmap, mean_score, classification, metrics


def test_image_directory(predictor: MultimodalPredictor, image_dir: str,
                         output_dir: str, max_images: Optional[int] = None,
                         batch_size: int = 8, save_figures: bool = False) -> List[Dict]:
    """Every image of ``image_dir`` (sorted; the first ``max_images``)
    through ``predictor`` in batches padded to ``batch_size``; an image that
    fails to decode is reported and skipped. Writes and returns the records
    of ``batch_results.json``; ``save_figures`` also writes each image's
    8-panel ``pred_<name>`` figure."""
    files = sorted(f for f in os.listdir(image_dir)
                   if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    if max_images:
        files = files[:max_images]
    os.makedirs(output_dir, exist_ok=True)

    results: List[Dict] = []
    size = predictor.rg_pipeline.image_size
    for i in range(0, len(files), batch_size):
        images, ok_files = [], []
        for f in files[i: i + batch_size]:
            try:
                images.append(load_image_u8(os.path.join(image_dir, f), size))
                ok_files.append(f)
            except Exception as e:  # decode fault tolerance
                print(f"error processing {f}: {e}")
        if not images:
            continue
        out = predictor.predict_batch(stages.pad_batch(images, batch_size))
        for j, f in enumerate(ok_files):
            prob = out["mask_prob"][j]
            pred_label = int(np.argmax(out["mask_logits"][j]))
            results.append({
                "image": f,
                "prediction": "Camouflaged" if pred_label == 1 else "Not Camouflaged",
                "pred_label": pred_label,
                "camo_prob": float(prob[1]),
                "not_camo_prob": float(prob[0]),
                "score": float(out["score"][j, 0]),
            })
            if save_figures:
                from camouflage_multimodal_tpu_torch.viz import multimodal_panel

                node_mask = out["node_mask"][j]
                predictions = {
                    "mask_prob": prob,
                    "mask_pred": pred_label,
                    "instance_pred": int(np.argmax(out["instance_logits"][j])),
                    "score": float(out["score"][j, 0]),
                    "segments": out["segments"][j],
                }
                attn = ({"rg2kg": out["attention"]["rg2kg"][j][node_mask]}
                        if "attention" in out else None)
                multimodal_panel(images[j], predictions, attn, predictor.kg_ordered,
                                 os.path.join(output_dir, f"pred_{f}"), f)

    with open(os.path.join(output_dir, "batch_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def evaluate_directory(checkpoint_path: str, image_dir: str, gt_dir: str,
                       n_segments: int = 500, batch_size: int = 16,
                       max_images: Optional[int] = None,
                       threshold: float = 0.5,
                       skip_images: int = 0,
                       files: Optional[List[str]] = None,
                       data_parallel: Optional[bool] = None,
                       image_size: int = 256,
                       feature_norm: Optional[int] = None,
                       device: str | torch.device = "cuda",
                       use_native: bool = True) -> Dict[str, float]:
    """Batched RG evaluation: the mean and std of every metric of
    :func:`eval.metrics.evaluate_segmentation` plus the curve scalars of
    :func:`eval.curves.batch_curve_metrics`, computed on ``device``.

    ``skip_images`` drops the first N files of the sorted listing (a held
    out tail); ``files`` (names inside ``image_dir``) replaces the listing;
    images without a ``<base>.png`` in ``gt_dir`` are skipped.
    ``feature_norm=256`` runs the reference's /256 position normalization
    for reference-recipe weights at other sizes. Decode ∥ upload ∥ compute
    ∥ download overlap as in :mod:`extract`; every batch is padded to
    ``batch_size``. Images decode through the native threaded loader
    (:mod:`native`; a file it rejects is decoded again with PIL, as in the
    JAX package), or through PIL with ``use_native=False``.

    ``data_parallel`` spreads every padded batch over the ranks of the
    process group (:mod:`parallel.distributed`): each rank decodes and runs
    its block, and the heatmaps and masks are gathered, so every rank
    computes the report one rank would. ``None`` turns it on
    when more than one process is up and ``batch_size`` divides over them;
    ``True`` with a batch that does not divide raises."""
    dev = resolve_device(device)
    world = process_count()
    if data_parallel is None:
        data_parallel = world > 1 and batch_size % world == 0
    group = None
    if data_parallel and world > 1:
        if batch_size % world:
            raise ValueError(
                f"data_parallel eval needs batch_size divisible by the "
                f"process count: batch_size={batch_size}, processes={world}")
        group = data_group(make_mesh(dev))
    pipeline = RegionGraphPipeline(load_rg_model(checkpoint_path, dev),
                                   n_segments=n_segments, image_size=image_size,
                                   feature_norm=feature_norm)
    if files is None:
        files = sorted(f for f in os.listdir(image_dir)
                       if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
        files = files[skip_images:]
    if max_images:
        files = files[:max_images]
    size = pipeline.image_size
    mine = block(batch_size, group)          # this rank's rows of every padded batch

    def paired(chunk):
        pairs = [(f, os.path.join(gt_dir, os.path.splitext(f)[0] + ".png")) for f in chunk]
        return [(f, g) for f, g in pairs if os.path.exists(g)]

    chunks = [paired(files[i: i + batch_size]) for i in range(0, len(files), batch_size)]
    starts = np.cumsum([0] + [len(c) for c in chunks])
    # The global index of every image this rank evaluates, in order.
    rows = [i for c, start in zip(chunks, starts)
            for i in range(start, start + len(c))[mine]]

    def decode(pairs):
        """(uint8 images, float masks) of this rank's GT-paired files."""
        pairs = pairs[mine]
        paths = [os.path.join(image_dir, f) for f, _ in pairs]
        if use_native and paths:
            batch, ok = native.load_batch_u8(paths, size)
            images = [one if good else load_image_u8(p, size)
                      for p, one, good in zip(paths, batch, ok)]
        else:
            images = [load_image_u8(p, size) for p in paths]
        return images, [load_mask(g, size) for _, g in pairs]

    def upload(decoded):
        images, masks = decoded
        if not images:
            return None, masks
        return stages.upload(stages.pad_batch(images, mine.stop - mine.start), dev), masks

    heatmaps, gts = [], []

    def compute(uploaded):
        batch, masks = uploaded
        if batch is None:
            return None
        gts.append(np.stack(masks))
        return pipeline(batch)["heatmap"][:len(masks)]

    stages.run_overlapped(chunks, decode, upload, compute, lambda h: h.cpu().numpy(),
                          heatmaps.append)
    # Every rank's heatmaps and masks at their global rows, on every rank.
    idx = torch.tensor(rows, dtype=torch.long, device=dev)
    preds, gt = (scatter_rows(torch.from_numpy(np.concatenate(parts) if parts else
                                               np.zeros((0, size, size), np.float32)).to(dev),
                              idx, int(starts[-1]), group) for parts in (heatmaps, gts))
    report = {k: float(v) for k, v in batch_evaluate(preds, gt, threshold).items()}
    report.update({k: float(v) for k, v in batch_curve_metrics(preds, gt).items()})
    return report


def visualize_prediction(image_path: str, predictions: Dict, attention_weights,
                         kg_categories_ordered: Dict, output_path: str) -> None:
    """The reference's 8-panel multimodal figure
    (``test_multimodal.py:156-308``)."""
    from camouflage_multimodal_tpu_torch.viz import multimodal_panel

    image = load_image_rgb(image_path)
    multimodal_panel(image, predictions, attention_weights, kg_categories_ordered,
                     output_path, os.path.basename(image_path))
