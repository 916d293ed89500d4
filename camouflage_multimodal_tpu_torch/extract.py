"""Offline RG embedding extraction from an image directory.

Port of ``camouflage_multimodal_tpu/extract.py``: walks a directory,
extracts each image's node embeddings (N, 128) and graph embedding
(1, 128), and writes the combined store ``all_rg_embeddings.npz``,
``embedding_summary.json`` with the same schema and, with
``save_individual``, ``<base>_embedding.npz`` per image. Images go through
the pipeline in device batches (padded to ``batch_size``), with decode ∥
upload ∥ compute ∥ download overlapped (:mod:`core.stages`); a batch
decodes through the native threaded loader (:mod:`native`, the same bytes
as PIL). Each record keeps only the image's real nodes: the
padding rows are stripped by ``node_mask``. The pipeline's graph build
launches kernel B1 ``num_iters`` times per batch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from camouflage_multimodal_tpu_torch import native
from camouflage_multimodal_tpu_torch.core import stages
from camouflage_multimodal_tpu_torch.core.artifacts import save_rg_embeddings
from camouflage_multimodal_tpu_torch.data.cod10k import IMAGE_EXTS, load_image_u8
from camouflage_multimodal_tpu_torch.pipeline import RegionGraphPipeline


def pipeline_device(pipeline: RegionGraphPipeline) -> torch.device:
    """The device the pipeline's model lives on."""
    return next(pipeline.model.parameters()).device


def extract_embeddings_from_image(pipeline: RegionGraphPipeline, image_path: str):
    """One image → (node_embeddings (N, 128), graph_embedding (1, 128),
    segments (H, W))."""
    image = load_image_u8(image_path, pipeline.image_size)
    out = pipeline(stages.upload(image[None], pipeline_device(pipeline)))
    got = stages.download(out, ("node_mask", "node_embeddings", "graph_embedding", "segments"))
    node_emb = got["node_embeddings"][0][got["node_mask"][0]]
    return node_emb, got["graph_embedding"][0][None], got["segments"][0]


def batch_extract_embeddings(pipeline: RegionGraphPipeline, image_dir: str,
                             output_dir: str, max_images: Optional[int] = None,
                             batch_size: int = 16, save_individual: bool = False,
                             log_fn=print) -> Tuple[Dict, Dict]:
    """Extract every image of ``image_dir`` (sorted; the first
    ``max_images``) and write the stores into ``output_dir``. Returns
    (image name → {node_embeddings, graph_embedding, num_nodes}, summary).
    An image the native decoder rejects is recorded as failed and
    skipped, as in the JAX package."""
    os.makedirs(output_dir, exist_ok=True)
    image_files = sorted(f for f in os.listdir(image_dir) if f.lower().endswith(IMAGE_EXTS))
    if max_images:
        image_files = image_files[:max_images]
    total = len(image_files)
    device = pipeline_device(pipeline)

    all_embeddings: Dict[str, Dict] = {}
    summary = {
        "total_images": total,
        "embedding_dim": 128,
        "n_segments": pipeline.n_segments,
        "model_path": None,
        "processing_time": None,
        "images": {},
    }
    failed = []
    start = time.time()

    def decode(chunk):
        """uint8 images of the chunk that decode; a failure is logged in
        ``failed`` and the image skipped."""
        images, names = [], []
        batch, ok = native.load_batch_u8([os.path.join(image_dir, f) for f in chunk],
                                         pipeline.image_size)
        for f, one, good in zip(chunk, batch, ok):
            if good:
                images.append(one)
                names.append(f)
            else:
                failed.append((f, "native decode failed"))
        return images, names

    def upload(decoded):
        images, names = decoded
        if not images:
            return None, names
        return stages.upload(stages.pad_batch(images, batch_size), device), names

    def compute(uploaded):
        batch, names = uploaded
        return None if batch is None else (names, pipeline(batch))

    keys = ["node_mask", "node_embeddings", "graph_embedding"]
    if save_individual:
        keys += ["segments", "region_features"]

    def download(computed):
        names, out = computed
        return names, stages.download(out, keys)

    def record(downloaded):
        names, out = downloaded
        node_mask = out["node_mask"]
        for j, name in enumerate(names):
            node_emb = out["node_embeddings"][j][node_mask[j]]
            graph_emb = out["graph_embedding"][j][None]
            all_embeddings[name] = {"node_embeddings": node_emb,
                                    "graph_embedding": graph_emb,
                                    "num_nodes": int(node_emb.shape[0])}
            if save_individual:
                np.savez_compressed(
                    os.path.join(output_dir, f"{os.path.splitext(name)[0]}_embedding.npz"),
                    image_name=name, node_embeddings=node_emb,
                    graph_embedding=graph_emb, num_nodes=node_emb.shape[0],
                    segments=out["segments"][j],
                    node_features=out["region_features"][j][node_mask[j]])
            summary["images"][name] = {
                "num_nodes": int(node_emb.shape[0]),
                "node_embedding_shape": list(node_emb.shape),
                "graph_embedding_shape": list(graph_emb.shape),
            }
        done = len(all_embeddings) + len(failed)
        elapsed = time.time() - start
        rate = done / elapsed if elapsed > 0 else 0.0
        log_fn(f"  {done}/{total} images ({rate:.1f} img/s, "
               f"ETA {((total - done) / max(rate, 1e-9)):.0f}s)")

    chunks = [image_files[i: i + batch_size] for i in range(0, total, batch_size)]
    stages.run_overlapped(chunks, decode, upload, compute, download, record)

    total_time = time.time() - start
    successful = len(all_embeddings)
    save_rg_embeddings(os.path.join(output_dir, "all_rg_embeddings.npz"), all_embeddings)
    summary["processing_time"] = {
        "total_seconds": total_time,
        "avg_per_image": total_time / successful if successful else 0.0,
        "successful_images": successful,
        "failed_images": len(failed),
    }
    with open(os.path.join(output_dir, "embedding_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return all_embeddings, summary


def format_time(seconds: float) -> str:
    """Readable duration."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        return f"{seconds / 60:.1f}m"
    return f"{seconds / 3600:.2f}h"
